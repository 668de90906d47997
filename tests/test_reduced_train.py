"""Post-truncation recovery fine-tune: dense-view parity, exact gradients,
loop wiring, and accuracy recovery.

The reference's reduced cell is inference-only (every weight
``trainable=False``, reference code/svd_classes_v3.py:249-315) — recovery
is a beyond-reference stage. These tests pin (a) the differentiable dense
view against both the two-step forward and the battle-tested
ops.layouts.reconstruct_dense_model, (b) exact chain-rule gradient parity
for every (B, C) factor against autodiff of the two-step scan, (c) that
``fit(recurrence_kernel=True)`` takes the kernel path for
``reduced_lstm_apply``, and (d) that recovery actually recovers accuracy
lost to an aggressive cutoff while preserving the two-step
parameterization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svd_lstm_tpu.config import TrainConfig
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.models.reduced import ReducedModelParams, reduced_lstm_apply
from svd_lstm_tpu.ops.reduced_train import (
    reduced_dense_view,
    reduced_lstm_apply_fast_train,
)
from svd_lstm_tpu.train.finetune import finetune_reduced


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _model(merged: bool, units=(12, 12), d=8, rank=None, cutoff=None) -> ReducedModelParams:
    dense = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=d, units=units)
    s = make_singular_model(dense, merged_kernel=merged)
    if rank is None and cutoff is None:
        rank = 8
    return make_reduced_model(s, cutoff=cutoff, rank=rank)


@pytest.mark.parametrize("merged", [False, True])
def test_dense_view_matches_two_step_forward(rng, merged):
    r = _model(merged)
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply

    x = jnp.asarray(rng.normal(size=(4, 7, 8)).astype(np.float32))
    y_view = np.asarray(
        stacked_lstm_apply(reduced_dense_view(r), x, return_sequences=True)
    )
    y_ref = np.asarray(reduced_lstm_apply(r, x, return_sequences=True))
    np.testing.assert_allclose(y_view, y_ref, atol=1e-5)


@pytest.mark.parametrize("merged", [False, True])
def test_dense_view_matches_layouts_reconstruction(merged):
    """Two independent reconstructions of the same layout-critical
    column ordering (reduced_train vs ops.layouts) cannot drift."""
    from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

    r = _model(merged)
    view = reduced_dense_view(r)
    ref = reconstruct_dense_model(r)
    for lv, lr in zip(view.layers, ref.layers):
        np.testing.assert_allclose(np.asarray(lv.W), np.asarray(lr.W), atol=1e-6)
        np.testing.assert_allclose(np.asarray(lv.U), np.asarray(lr.U), atol=1e-6)
        np.testing.assert_allclose(np.asarray(lv.b), np.asarray(lr.b), atol=0)


def test_dense_view_uneven_per_gate_ranks(rng):
    """Cutoff truncation leaves different ranks per gate; the dense view
    must keep each gate's own (B, C) widths straight."""
    r = _model(False, cutoff=0.9, rank=None)
    ranks = {tuple(B.shape[1] for B in l.wB) for l in r.layers}
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply

    x = jnp.asarray(rng.normal(size=(2, 5, 8)).astype(np.float32))
    y_view = np.asarray(
        stacked_lstm_apply(reduced_dense_view(r), x, return_sequences=True)
    )
    y_ref = np.asarray(reduced_lstm_apply(r, x, return_sequences=True))
    np.testing.assert_allclose(y_view, y_ref, atol=1e-5)
    assert ranks  # sanity: model built


@pytest.mark.parametrize("merged", [False, True])
def test_forward_parity_interpret(rng, merged):
    r = _model(merged)
    x = jnp.asarray(rng.normal(size=(8, 6, 8)).astype(np.float32))
    y_ref = np.asarray(reduced_lstm_apply(r, x, return_sequences=True))
    y = np.asarray(reduced_lstm_apply_fast_train(r, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


@pytest.mark.parametrize("merged", [False, True])
def test_gradient_parity_all_factors(rng, merged):
    """dB/dC/db/dhead through the kernel path == autodiff of the two-step
    scan forward (CPU interpret: all dots f32, so parity is tight)."""
    r = _model(merged)
    x = jnp.asarray(rng.normal(size=(8, 6, 8)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(8,)).astype(np.float32))

    def loss(fn):
        def f(p):
            pred = fn(p, x, return_sequences=False)[..., 0]
            return jnp.mean(jnp.square(pred - y))

        return f

    g_ref = jax.grad(loss(reduced_lstm_apply))(r)
    g_ker = jax.grad(
        loss(lambda p, xx, return_sequences: reduced_lstm_apply_fast_train(
            p, xx, return_sequences=return_sequences
        ))
    )(r)
    for a, b, path in zip(
        jax.tree.leaves(g_ker),
        jax.tree.leaves(g_ref),
        jax.tree_util.tree_leaves_with_path(g_ref),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5,
            err_msg=f"gradient mismatch at {jax.tree_util.keystr(path[0])}",
        )


def test_recover_honors_recurrence_kernel(rng, monkeypatch):
    """fit() swaps reduced_lstm_apply for the kernel path when
    TrainConfig.recurrence_kernel=True."""
    import svd_lstm_tpu.ops.reduced_train as rt_mod

    calls = {"n": 0}
    orig = rt_mod.reduced_lstm_apply_fast_train

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(rt_mod, "reduced_lstm_apply_fast_train", spy)

    r = _model(False)
    X = rng.normal(size=(1, 64, 8)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    cfg = TrainConfig(
        epochs=1, num_windows=16, window_len=6, batch_size=8,
        recurrence_kernel=True,
    )
    res = finetune_reduced(r, X, yfull, train_cfg=cfg)
    assert calls["n"] > 0, "kernel path not taken"
    assert np.isfinite(res.history).all()


def test_recover_kernel_matches_scan_losses(rng):
    """One recovery epoch, kernel path vs scan path: identical window
    sampling, f32 CPU dots everywhere ⇒ losses and params agree."""
    X = rng.normal(size=(1, 64, 8)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    base = dict(epochs=2, num_windows=16, window_len=6, batch_size=8, seed=5)

    r = _model(False)
    r_scan = finetune_reduced(r, X, yfull, train_cfg=TrainConfig(**base))
    r_ker = finetune_reduced(
        r, X, yfull, train_cfg=TrainConfig(**base, recurrence_kernel=True)
    )
    np.testing.assert_allclose(r_ker.history, r_scan.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_ker.params), jax.tree.leaves(r_scan.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_recovery_recovers_accuracy(rng):
    """Aggressive truncation destroys accuracy; recovery fine-tune wins it
    back while keeping the compressed structure (same ranks, same
    weight_count) — the stage the reference cannot run."""
    from svd_lstm_tpu.data.dropbear import preprocess_raw
    from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw
    from svd_lstm_tpu.config import DataConfig
    from svd_lstm_tpu.train.loop import fit, predict_full_run

    ds = preprocess_raw(
        synthetic_dropbear_raw(duration=6.0), DataConfig(split_time=4.0)
    )
    dense = init_stacked_lstm(jax.random.PRNGKey(0), 16, (12, 12))
    cfg = TrainConfig(epochs=3, num_windows=256, window_len=40, batch_size=32)
    dense = fit(dense, ds.X_train, ds.y_train, cfg).params

    s = make_singular_model(dense, merged_kernel=False)
    r = make_reduced_model(s, cutoff=None, rank=5)  # aggressive: 5 of 12

    def run_mse(p):
        pred = predict_full_run(p, ds.X_test, apply_fn=reduced_lstm_apply)
        return float(np.mean(np.square(pred - ds.y_test)))

    before = run_mse(r)
    res = finetune_reduced(
        r, ds.X_train, ds.y_train,
        train_cfg=TrainConfig(
            epochs=3, num_windows=256, window_len=40, batch_size=32
        ),
    )
    after = run_mse(res.params)
    assert after < before, (before, after)

    # the compressed parameterization is preserved: same tree structure,
    # same per-gate ranks, same stored-weight count
    assert jax.tree_util.tree_structure(res.params) == jax.tree_util.tree_structure(r)
    for l0, l1 in zip(r.layers, res.params.layers):
        assert [B.shape for B in l0.wB] == [B.shape for B in l1.wB]
    total0 = sum(l.weight_count() for l in r.layers)
    total1 = sum(l.weight_count() for l in res.params.layers)
    assert total0 == total1


def test_recover_conv_hybrid_runs(rng):
    """Family dispatch: ConvReducedParams trains through conv_reduced_apply."""
    from svd_lstm_tpu.factor.svd import (
        make_conv_reduced_model,
        make_conv_singular_model,
    )
    from svd_lstm_tpu.models.conv import init_conv_lstm

    hybrid = init_conv_lstm(
        jax.random.PRNGKey(2), in_channels=4, filters=8, kernel_size=5, units=(8,)
    )
    ch_r = make_conv_reduced_model(
        make_conv_singular_model(hybrid), cutoff=None, rank=5
    )
    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    res = finetune_reduced(
        ch_r, X, yfull,
        train_cfg=TrainConfig(epochs=1, num_windows=16, window_len=6, batch_size=8),
    )
    assert np.isfinite(res.history).all()
    assert jax.tree_util.tree_structure(res.params) == jax.tree_util.tree_structure(ch_r)


def test_large_batch_chunks_through_kernel(rng):
    """A large batch (B=504: 32 batch tiles, the last one padded) runs
    the kernel's batch-tile grid; the forward matches the factored scan
    exactly, padded rows sliced away."""
    r = _model(False, units=(12,), d=8)
    x = jnp.asarray(rng.normal(size=(504, 5, 8)).astype(np.float32))
    y_ref = np.asarray(reduced_lstm_apply(r, x, return_sequences=True))
    y = np.asarray(reduced_lstm_apply_fast_train(r, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
