"""Kernel-accelerated singular fine-tune: gradient parity + loop wiring.

The reference's fine-tune stage (code/svd_acceleration_v3.py:119-128)
trains the factorized model; ops/singular_train.py routes that training
through the recurrence kernel pair via a differentiable dense
reconstruction. These tests pin (a) forward parity, (b) EXACT chain-rule
gradient parity for every factor (σ, U, V, b, head) against autodiff of
the factored scan forward, and (c) that `fit(recurrence_kernel=True)`
actually takes the kernel path for `singular_lstm_apply`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svd_lstm_tpu.config import FactorConfig, TrainConfig
from svd_lstm_tpu.factor.svd import make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.models.singular import singular_lstm_apply
from svd_lstm_tpu.ops.singular_train import (
    singular_dense_view,
    singular_lstm_apply_fast_train,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _model(merged: bool, units=(12, 12), d=8):
    dense = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=d, units=units)
    return make_singular_model(dense, merged_kernel=merged)


@pytest.mark.parametrize("merged", [False, True])
def test_dense_view_matches_numpy_reconstruction(merged):
    s = _model(merged)
    from svd_lstm_tpu.factor.svd import singular_to_dense

    view = singular_dense_view(s)
    ref = singular_to_dense(s)
    for lv, lr in zip(view.layers, ref.layers):
        np.testing.assert_allclose(np.asarray(lv.W), np.asarray(lr.W), atol=1e-6)
        np.testing.assert_allclose(np.asarray(lv.U), np.asarray(lr.U), atol=1e-6)
        np.testing.assert_allclose(np.asarray(lv.b), np.asarray(lr.b), atol=0)


@pytest.mark.parametrize("merged", [False, True])
def test_forward_parity_interpret(rng, merged):
    s = _model(merged)
    x = jnp.asarray(rng.normal(size=(8, 6, 8)).astype(np.float32))
    y_ref = np.asarray(singular_lstm_apply(s, x, return_sequences=True))
    y = np.asarray(singular_lstm_apply_fast_train(s, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


@pytest.mark.parametrize("merged", [False, True])
def test_gradient_parity_all_factors(rng, merged):
    """dσ/dU/dV/db/dhead through the kernel path == autodiff of the
    factored scan forward (CPU interpret: all dots f32, so parity is
    tight)."""
    s = _model(merged)
    x = jnp.asarray(rng.normal(size=(8, 6, 8)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(8,)).astype(np.float32))

    def loss(fn):
        def f(p):
            pred = fn(p, x, return_sequences=False)[..., 0]
            return jnp.mean(jnp.square(pred - y))

        return f

    g_ref = jax.grad(loss(singular_lstm_apply))(s)
    g_ker = jax.grad(
        loss(lambda p, xx, return_sequences: singular_lstm_apply_fast_train(
            p, xx, return_sequences=return_sequences
        ))
    )(s)
    for a, b, path in zip(
        jax.tree.leaves(g_ker),
        jax.tree.leaves(g_ref),
        jax.tree_util.tree_leaves_with_path(g_ref),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5,
            err_msg=f"gradient mismatch at {jax.tree_util.keystr(path[0])}",
        )


def test_finetune_honors_recurrence_kernel(rng, monkeypatch):
    """fit() swaps singular_lstm_apply for the kernel path when
    TrainConfig.recurrence_kernel=True."""
    import svd_lstm_tpu.ops.singular_train as st_mod
    from svd_lstm_tpu.train.finetune import finetune

    calls = {"n": 0}
    orig = st_mod.singular_lstm_apply_fast_train

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(st_mod, "singular_lstm_apply_fast_train", spy)

    s = _model(False)
    X = rng.normal(size=(1, 64, 8)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    cfg = TrainConfig(
        epochs=1, num_windows=16, window_len=6, batch_size=8,
        recurrence_kernel=True,
    )
    res = finetune(
        s, X, yfull,
        factor_cfg=FactorConfig(hoyer=0.01),
        train_cfg=cfg,
    )
    assert calls["n"] > 0, "kernel path not taken"
    assert np.isfinite(res.history).all()


def test_finetune_kernel_matches_scan_losses(rng):
    """One fine-tune epoch, kernel path vs scan path: identical window
    sampling, f32 CPU dots everywhere ⇒ losses agree closely."""
    from svd_lstm_tpu.train.finetune import finetune

    X = rng.normal(size=(1, 64, 8)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    fcfg = FactorConfig(hoyer=0.01)
    base = dict(epochs=2, num_windows=16, window_len=6, batch_size=8, seed=5)

    s = _model(False)
    r_scan = finetune(s, X, yfull, factor_cfg=fcfg,
                      train_cfg=TrainConfig(**base))
    r_ker = finetune(s, X, yfull, factor_cfg=fcfg,
                     train_cfg=TrainConfig(**base, recurrence_kernel=True))
    np.testing.assert_allclose(r_ker.history, r_scan.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_ker.params), jax.tree.leaves(r_scan.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_large_batch_chunks_through_kernel(rng):
    """A large batch (B=504: 32 batch tiles, the last one padded) runs
    the kernel's batch-tile grid and still matches the factored forward
    exactly."""
    s = _model(False, units=(12,), d=8)
    x = jnp.asarray(rng.normal(size=(504, 5, 8)).astype(np.float32))
    y_ref = np.asarray(singular_lstm_apply(s, x, return_sequences=True))
    y = np.asarray(singular_lstm_apply_fast_train(s, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_chunked_gradients_exact(rng):
    """Gradients through a large padded batch (B=504) match autodiff of
    the factored scan — the pad rows of the last batch tile are
    gradient-inert."""
    s = _model(False, units=(12,), d=8)
    x = jnp.asarray(rng.normal(size=(504, 4, 8)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(504,)).astype(np.float32))

    def loss(fn):
        def f(p):
            pred = fn(p, x)[..., 0]
            return jnp.mean(jnp.square(pred - y))

        return f

    g_ref = jax.grad(loss(
        lambda p, xx: singular_lstm_apply(p, xx, return_sequences=False)
    ))(s)
    g_ker = jax.grad(loss(
        lambda p, xx: singular_lstm_apply_fast_train(
            p, xx, return_sequences=False
        )
    ))(s)
    for a, b, path in zip(
        jax.tree.leaves(g_ker),
        jax.tree.leaves(g_ref),
        jax.tree_util.tree_leaves_with_path(g_ref),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5,
            err_msg=f"gradient mismatch at {jax.tree_util.keystr(path[0])}",
        )


def test_wide_large_batch_falls_back_to_scan(rng):
    """Stacks wider than the kernel takes (units > 128) train on the
    exact scan."""
    s = _model(False, units=(130,), d=8)
    x = jnp.asarray(rng.normal(size=(136, 4, 8)).astype(np.float32))
    y_ref = np.asarray(singular_lstm_apply(s, x, return_sequences=True))
    y = np.asarray(singular_lstm_apply_fast_train(s, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-4)


def test_wide_singular_routes_through_uniform_kernel_path(rng):
    """A 128-unit singular model (the widest the kernel takes) trains
    through the kernel pair via its dense view — forward parity in
    interpret mode."""
    s = _model(False, units=(128, 128), d=8)
    x = jnp.asarray(rng.normal(size=(8, 3, 8)).astype(np.float32))
    y_ref = np.asarray(singular_lstm_apply(s, x, return_sequences=True))
    y = np.asarray(singular_lstm_apply_fast_train(s, x))
    np.testing.assert_allclose(y, y_ref, atol=2e-5)
