"""Trainable recurrence kernel pair (ops/gpu_recurrence.py): interpret-mode
forward parity and gradient parity with autodiff of the scan recurrence.
On the CPU every dot is exact f32 whatever its precision flag, so the
kernel and the scan run the same arithmetic up to summation order; the
tolerances below (1e-5 on O(1) values, 2e-4 on summed gradients) bound
that reordering."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svd_lstm_tpu.models.lstm import gate_update, init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.ops.gpu_recurrence import (
    lstm_recurrence,
    lstm_recurrence_fwd,
    stacked_lstm_apply_fast_train,
)


def _fwd_scan_hc(xp, U):
    """The lax.scan recurrence returning (h_seq, c_seq): the reference."""
    T, B, _ = xp.shape
    n = U.shape[0]

    def step(carry, xp_t):
        h, c = gate_update(xp_t + carry[0] @ U, carry[1])
        return (h, c), (h, c)

    zero = jnp.zeros((B, n), jnp.float32)
    return jax.lax.scan(step, (zero, zero), xp)[1]


@pytest.mark.parametrize("T,B,n", [(5, 8, 128), (4, 12, 128)])  # 12: batch padding
def test_recurrence_gradients_match_autodiff(rng, T, B, n):
    U = jnp.asarray(rng.normal(size=(n, 4 * n)).astype(np.float32)) * 0.05
    xp = jnp.asarray(rng.normal(size=(T, B, 4 * n)).astype(np.float32))
    cot = jnp.asarray(rng.normal(size=(T, B, n)).astype(np.float32))

    def loss_ref(xp, U):
        return jnp.sum(_fwd_scan_hc(xp, U)[0] * cot)

    def loss_kernel(xp, U):
        return jnp.sum(lstm_recurrence(xp, U, "default") * cot)

    g_ref = jax.grad(loss_ref, argnums=(0, 1))(xp, U)
    g_k = jax.grad(loss_kernel, argnums=(0, 1))(xp, U)
    np.testing.assert_allclose(np.asarray(g_k[0]), np.asarray(g_ref[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_k[1]), np.asarray(g_ref[1]), atol=1e-5)


def test_apply_fast_train_matches_exact_forward(rng):
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=6, units=(128, 24))
    x = jnp.asarray(rng.normal(size=(8, 9, 6)).astype(np.float32))
    y_ref = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y = np.asarray(stacked_lstm_apply_fast_train(params, x))
    # CPU DEFAULT-precision dots are exact f32 — identical arithmetic
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    y_last = np.asarray(
        stacked_lstm_apply_fast_train(params, x, return_sequences=False)
    )
    np.testing.assert_allclose(y_last, y_ref[:, -1], atol=1e-5)


def test_fit_with_fast_train_apply(rng):
    """End-to-end: fit() trains through the custom-VJP recurrence and
    matches the scan-apply fit's loss trajectory on CPU (same arithmetic)."""
    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.train.loop import fit

    X = rng.normal(size=(1, 160, 6)).astype(np.float32)
    y = np.convolve(X[0, :, 0], np.ones(4) / 4, mode="same").astype(np.float32)
    params = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=6, units=(128,))
    cfg = TrainConfig(num_windows=16, window_len=10, batch_size=8, epochs=2)

    r_fast = fit(params, X, y, cfg=cfg, apply_fn=stacked_lstm_apply_fast_train)
    r_scan = fit(params, X, y, cfg=cfg)
    assert np.isfinite(r_fast.history).all()
    # identical arithmetic on CPU up to dot-order roundoff
    np.testing.assert_allclose(r_fast.history, r_scan.history, rtol=1e-3)


def test_fit_recurrence_kernel_config_flag(rng):
    """TrainConfig.recurrence_kernel=True swaps the default apply for the
    custom-VJP kernel path (interpret mode on CPU) and trains to the same
    losses as the scan."""
    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.train.loop import fit

    X = rng.normal(size=(1, 120, 6)).astype(np.float32)
    y = np.convolve(X[0, :, 0], np.ones(4) / 4, mode="same").astype(np.float32)
    params = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=6, units=(128,))
    base = dict(num_windows=16, window_len=10, batch_size=8, epochs=2)
    r_k = fit(params, X, y, cfg=TrainConfig(recurrence_kernel=True, **base))
    r_s = fit(params, X, y, cfg=TrainConfig(**base))
    np.testing.assert_allclose(r_k.history, r_s.history, rtol=1e-3)


def test_apply_fast_train_uniform_stack_scan_path(rng):
    """Stacks with a layer wider than the kernel takes (n > 128) train on
    the lax.scan: values and gradients are the scan's own."""
    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=6, units=(256, 256))
    x = jnp.asarray(rng.normal(size=(8, 5, 6)).astype(np.float32))
    y_ref = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y = np.asarray(stacked_lstm_apply_fast_train(params, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)

    def loss(p):
        return jnp.sum(stacked_lstm_apply_fast_train(p, x) ** 2)

    def loss_ref(p):
        return jnp.sum(stacked_lstm_apply(p, x, return_sequences=True) ** 2)

    g = jax.grad(loss)(params)
    g_ref = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_apply_fast_train_narrow_fused_path(rng):
    """Narrow stacks (all n <= 128) run every layer's recurrence through
    the kernel pair — forward exact, gradients parity with autodiff."""
    params = init_stacked_lstm(
        jax.random.PRNGKey(4), input_dim=6, units=(40, 30, 40)
    )
    x = jnp.asarray(rng.normal(size=(8, 6, 6)).astype(np.float32))
    y_ref = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y = np.asarray(stacked_lstm_apply_fast_train(params, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)

    def loss(p):
        return jnp.sum(stacked_lstm_apply_fast_train(p, x, return_sequences=False) ** 2)

    def loss_ref(p):
        return jnp.sum(stacked_lstm_apply(p, x, return_sequences=False) ** 2)

    g = jax.grad(loss)(params)
    g_ref = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_fused_fwd_kernel_matches_scan_directly(rng):
    """The forward kernel's own (h_seq, c_seq) — the residuals the backward
    kernel reads — must reproduce the scan's states."""
    xp = jnp.asarray(rng.normal(size=(5, 8, 4 * 40)).astype(np.float32))
    U = jnp.asarray(rng.normal(size=(40, 4 * 40)).astype(np.float32)) * 0.1
    h, c = lstm_recurrence_fwd(xp, U)
    h_ref, c_ref = _fwd_scan_hc(xp, U)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(c), np.asarray(c_ref), atol=1e-5)


def test_apply_fast_train_uniform_stack_wide_input_fallback(rng):
    """An input wider than the layers (d=200 > n=128) is no obstacle: the
    input projection is hoisted out of the kernel, so the stack runs the
    kernel pair and matches the exact forward."""
    params = init_stacked_lstm(jax.random.PRNGKey(4), input_dim=200, units=(128, 128))
    x = jnp.asarray(rng.normal(size=(8, 4, 200)).astype(np.float32))
    y_ref = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y = np.asarray(stacked_lstm_apply_fast_train(params, x))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_apply_fast_train_balanced_chunk_boundaries(rng):
    """Large and odd batches need no chunking: the grid runs over 16-row
    batch tiles, zero-padding the last (B=600 -> 38 tiles with 8 pad rows;
    B=997 -> 63 tiles) and slicing back — both match the exact forward
    row-for-row."""
    params = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=6, units=(10,))
    for B in (600, 997):
        x = jnp.asarray(rng.normal(size=(B, 3, 6)).astype(np.float32))
        y_ref = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
        y = np.asarray(stacked_lstm_apply_fast_train(params, x))
        assert y.shape == y_ref.shape
        np.testing.assert_allclose(y, y_ref, atol=1e-5)
