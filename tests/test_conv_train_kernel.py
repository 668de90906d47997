"""Kernel-accelerated conv-hybrid training: gradient parity + loop wiring.

The reference trains its Conv1D+LSTM hybrid end-to-end
(code/old_versions/toy-convolution.py:70-76); ops/conv_train.py routes
that training through the recurrence kernel pair by hoisting the conv front
end (standard XLA VJP) and feeding the stack's fast-train applies. These
tests pin, per family (dense / singular / reduced hybrid):

(a) forward parity vs the scan applies,
(b) EXACT gradient parity for EVERY parameter — conv kernel/bias
    included (the kernel's dx cotangent must flow back through the conv)
    — against autodiff of the scan forward,
(c) that fit/finetune with ``TrainConfig(recurrence_kernel=True)``
    actually takes the kernel path for the hybrid applies,
(d) a large padded batch through the kernel's batch-tile grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svd_lstm_tpu.config import FactorConfig, TrainConfig
from svd_lstm_tpu.factor.svd import (
    make_conv_reduced_model,
    make_conv_singular_model,
)
from svd_lstm_tpu.models.conv import (
    conv_lstm_apply,
    conv_reduced_apply,
    conv_singular_apply,
    init_conv_lstm,
)
from svd_lstm_tpu.ops.conv_train import (
    conv_lstm_apply_fast_train,
    conv_reduced_apply_fast_train,
    conv_singular_apply_fast_train,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _hybrid(units=(12, 12), d=4, filters=8, kernel_size=5):
    return init_conv_lstm(
        jax.random.PRNGKey(3),
        in_channels=d,
        filters=filters,
        kernel_size=kernel_size,
        units=units,
    )


FAMILIES = {
    "dense": (
        lambda h: h,
        conv_lstm_apply,
        conv_lstm_apply_fast_train,
    ),
    "singular": (
        lambda h: make_conv_singular_model(h, merged_kernel=False),
        conv_singular_apply,
        conv_singular_apply_fast_train,
    ),
    "reduced": (
        lambda h: make_conv_reduced_model(
            make_conv_singular_model(h), rank=8
        ),
        conv_reduced_apply,
        conv_reduced_apply_fast_train,
    ),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_parity_interpret(rng, family):
    make, scan_apply, fast_apply = FAMILIES[family]
    p = make(_hybrid())
    x = jnp.asarray(rng.normal(size=(8, 6, 4)).astype(np.float32))
    y_ref = np.asarray(scan_apply(p, x, return_sequences=True))
    y = np.asarray(fast_apply(p, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradient_parity_all_params(rng, family):
    """Every parameter's gradient through the kernel path — conv w/b, the
    stack weights (or factors), head — equals autodiff of the scan forward
    (CPU interpret: all dots f32, so parity is tight)."""
    make, scan_apply, fast_apply = FAMILIES[family]
    p = make(_hybrid())
    x = jnp.asarray(rng.normal(size=(8, 6, 4)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(8,)).astype(np.float32))

    def loss(fn):
        def f(q):
            pred = fn(q, x, return_sequences=False)[..., 0]
            return jnp.mean(jnp.square(pred - y))

        return f

    g_ref = jax.grad(loss(scan_apply))(p)
    g_ker = jax.grad(
        loss(lambda q, xx, return_sequences: fast_apply(
            q, xx, return_sequences=return_sequences
        ))
    )(p)
    for a, b, path in zip(
        jax.tree.leaves(g_ker),
        jax.tree.leaves(g_ref),
        jax.tree_util.tree_leaves_with_path(g_ref),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5,
            err_msg=f"gradient mismatch at {jax.tree_util.keystr(path[0])}",
        )


def test_conv_gradient_nonzero(rng):
    """The conv front end genuinely receives cotangents through the
    kernel's dx (a silent zero here would train the stack but freeze the
    conv)."""
    p = _hybrid()
    x = jnp.asarray(rng.normal(size=(8, 6, 4)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(8,)).astype(np.float32))

    def f(q):
        pred = conv_lstm_apply_fast_train(
            q, x, return_sequences=False
        )[..., 0]
        return jnp.mean(jnp.square(pred - y))

    g = jax.grad(f)(p)
    assert float(jnp.abs(g.conv.w).max()) > 0
    assert float(jnp.abs(g.conv.b).max()) > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_chunked_large_batch(rng, family):
    """A large batch (B=504: 32 batch tiles, the last one padded) of
    conv-fed input runs the kernel's batch-tile grid and still matches
    the scan forward exactly."""
    make, scan_apply, fast_apply = FAMILIES[family]
    p = make(_hybrid(units=(12,)))
    x = jnp.asarray(rng.normal(size=(504, 5, 4)).astype(np.float32))
    y_ref = np.asarray(scan_apply(p, x, return_sequences=True))
    y = np.asarray(fast_apply(p, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_fit_honors_recurrence_kernel(rng, monkeypatch):
    """fit() swaps conv_lstm_apply for the kernel path when
    TrainConfig.recurrence_kernel=True."""
    import svd_lstm_tpu.ops.conv_train as ct_mod
    from svd_lstm_tpu.train.loop import fit

    calls = {"n": 0}
    orig = ct_mod.conv_lstm_apply_fast_train

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ct_mod, "conv_lstm_apply_fast_train", spy)

    p = _hybrid(units=(8,))
    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    cfg = TrainConfig(
        epochs=1, num_windows=16, window_len=6, batch_size=8,
        recurrence_kernel=True,
    )
    res = fit(p, X, yfull, cfg=cfg, apply_fn=conv_lstm_apply)
    assert calls["n"] > 0, "kernel path not taken"
    assert np.isfinite(res.history).all()


def test_fit_kernel_matches_scan_losses(rng):
    """Dense-hybrid training, kernel path vs scan path: identical window
    sampling, f32 CPU dots everywhere => losses and params agree."""
    from svd_lstm_tpu.train.loop import fit

    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    base = dict(epochs=2, num_windows=16, window_len=6, batch_size=8, seed=5)

    p = _hybrid(units=(8,))
    r_scan = fit(p, X, yfull, cfg=TrainConfig(**base), apply_fn=conv_lstm_apply)
    r_ker = fit(
        p, X, yfull, cfg=TrainConfig(**base, recurrence_kernel=True),
        apply_fn=conv_lstm_apply,
    )
    np.testing.assert_allclose(r_ker.history, r_scan.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_ker.params), jax.tree.leaves(r_scan.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_conv_singular_finetune_kernel_matches_scan(rng):
    """The hybrid σ fine-tune (Hoyer + masked adam) through the kernel
    engine matches the scan fine-tune — the hybrid analog of
    test_singular_train_kernel.test_finetune_kernel_matches_scan_losses."""
    from svd_lstm_tpu.train.finetune import finetune

    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    fcfg = FactorConfig(hoyer=0.01)
    base = dict(epochs=2, num_windows=16, window_len=6, batch_size=8, seed=5)

    cs = make_conv_singular_model(_hybrid(units=(8,)))
    r_scan = finetune(cs, X, yfull, factor_cfg=fcfg,
                      train_cfg=TrainConfig(**base))
    r_ker = finetune(cs, X, yfull, factor_cfg=fcfg,
                     train_cfg=TrainConfig(**base, recurrence_kernel=True))
    np.testing.assert_allclose(r_ker.history, r_scan.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_ker.params), jax.tree.leaves(r_scan.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_conv_reduced_recovery_kernel_matches_scan(rng):
    """The hybrid post-truncation recovery fine-tune through the kernel
    engine matches the scan loop."""
    from svd_lstm_tpu.train.finetune import finetune_reduced

    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    base = dict(epochs=2, num_windows=16, window_len=6, batch_size=8, seed=5)

    cr = make_conv_reduced_model(
        make_conv_singular_model(_hybrid(units=(8,))), rank=6
    )
    r_scan = finetune_reduced(cr, X, yfull, train_cfg=TrainConfig(**base))
    r_ker = finetune_reduced(
        cr, X, yfull, train_cfg=TrainConfig(**base, recurrence_kernel=True)
    )
    np.testing.assert_allclose(r_ker.history, r_scan.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_ker.params), jax.tree.leaves(r_scan.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_dropout_finetune_keeps_scan(rng, monkeypatch):
    """A dropout hybrid fine-tune must NOT take the kernel path (the
    kernels carry no mask support — the wrapper never identity-matches)."""
    import svd_lstm_tpu.ops.conv_train as ct_mod
    from svd_lstm_tpu.train.finetune import finetune

    def boom(*a, **k):
        raise AssertionError("kernel path taken under dropout")

    monkeypatch.setattr(ct_mod, "conv_singular_apply_fast_train", boom)

    cs = make_conv_singular_model(_hybrid(units=(8,)))
    X = rng.normal(size=(1, 64, 4)).astype(np.float32)
    yfull = rng.normal(size=(64,)).astype(np.float32)
    res = finetune(
        cs, X, yfull,
        factor_cfg=FactorConfig(hoyer=0.01, dropout=0.2),
        train_cfg=TrainConfig(
            epochs=1, num_windows=16, window_len=6, batch_size=8,
            recurrence_kernel=True,
        ),
    )
    assert np.isfinite(res.history).all()
