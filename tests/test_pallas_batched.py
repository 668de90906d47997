"""The recurrence kernel on batched input (ops/gpu_recurrence.py): the grid
runs over 16-row batch tiles, so multi-tile and padded batches must
reproduce the XLA scan exactly in f32 interpret mode, each tile must start
from a zero state, and the batched fast mode (bf16 XLA scan) must stay
within bf16 roundoff of the exact model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svd_lstm_tpu.api import predict
from svd_lstm_tpu.models.lstm import (
    gate_update,
    init_stacked_lstm,
    stacked_lstm_apply,
)
from svd_lstm_tpu.ops.gpu_recurrence import lstm_recurrence_fwd, stack_forward


def _scan_recurrence(xp, U):
    T, B, g4 = xp.shape
    n = U.shape[0]
    h0 = jnp.zeros((B, n), jnp.float32)
    c0 = jnp.zeros((B, n), jnp.float32)

    def step(carry, xp_t):
        h, c = carry
        h, c = gate_update(xp_t + h @ U, c)
        return (h, c), h

    _, h_seq = jax.lax.scan(step, (h0, c0), xp)
    return h_seq


@pytest.mark.parametrize(
    "T,B,n",
    [
        (7, 12, 40),    # gate padding (G=64) + batch padding (Bp=16)
        (4, 16, 128),   # gate width already a power of two, one batch tile
        (5, 40, 64),    # three batch tiles, the last one padded
    ],
)
def test_recurrence_matches_scan_f32(rng, T, B, n):
    U = jnp.asarray(rng.normal(size=(n, 4 * n)).astype(np.float32)) * 0.1
    xp = jnp.asarray(rng.normal(size=(T, B, 4 * n)).astype(np.float32))
    y_ref = np.asarray(_scan_recurrence(xp, U))
    y = np.asarray(lstm_recurrence_fwd(xp, U)[0])
    # the same f32 arithmetic in interpret mode, up to summation order
    np.testing.assert_allclose(y, y_ref, atol=1e-6)


def test_recurrence_state_resets_across_batch_tiles(rng):
    """Each batch tile's (h, c) must start from zero — a stale carry would
    leak tile i's final state into tile i+1's first step."""
    T, n = 3, 32
    U = jnp.asarray(rng.normal(size=(n, 4 * n)).astype(np.float32)) * 0.1
    xp_half = jnp.asarray(rng.normal(size=(T, 16, 4 * n)).astype(np.float32))
    xp = jnp.concatenate([xp_half, xp_half], axis=1)  # two identical tiles
    y = np.asarray(lstm_recurrence_fwd(xp, U)[0])
    np.testing.assert_array_equal(y[:, :16], y[:, 16:])


def test_forward_fast_close_to_exact(rng):
    params = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=6, units=(40, 128))
    x = jnp.asarray(rng.normal(size=(4, 9, 6)).astype(np.float32))
    y_exact = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y_fast = np.asarray(predict(params, x, precision="fast"))
    assert y_fast.shape == y_exact.shape
    rel = np.linalg.norm(y_fast - y_exact) / np.linalg.norm(y_exact)
    assert rel < 2e-2  # bf16 operand roundoff only


def test_forward_fast_narrow_layers_use_scan_fallback(rng):
    # the batched fast mode is the bf16 XLA scan for every width: the
    # result must be bf16-close to exact
    params = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=4, units=(24, 40))
    x = jnp.asarray(rng.normal(size=(3, 11, 4)).astype(np.float32))
    y_exact = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
    y_fast = np.asarray(predict(params, x, precision="fast"))
    rel = np.linalg.norm(y_fast - y_exact) / np.linalg.norm(y_exact)
    assert rel < 3e-2


def test_batch1_fast_dot_precision_exact_on_cpu(rng):
    """precision='default' (TF32 on the GPU, the fast mode) changes nothing
    in interpret mode — CPU f32 dots are exact whatever the flag."""
    params = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=4, units=(16, 16))
    x1 = jnp.asarray(rng.normal(size=(12, 4)).astype(np.float32))
    y_exact = np.asarray(stack_forward(params, x1, precision="highest"))
    y_fast = np.asarray(stack_forward(params, x1, precision="default"))
    np.testing.assert_array_equal(y_fast, y_exact)


def test_predict_fast_batch1_cpu_runs_exact(rng):
    params = init_stacked_lstm(jax.random.PRNGKey(6), input_dim=4, units=(16, 16))
    x1 = jnp.asarray(rng.normal(size=(12, 4)).astype(np.float32))
    y_exact = np.asarray(predict(params, x1, precision="exact"))
    y_fast = np.asarray(predict(params, x1, precision="fast"))
    np.testing.assert_allclose(y_fast, y_exact, atol=1e-6)


def test_predict_fast_dispatches_batched(rng):
    """predict(..., precision='fast') on batched input runs the bf16 XLA
    scan and matches the exact path to bf16 tolerance."""
    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=4, units=(16, 16))
    x = jnp.asarray(rng.normal(size=(2, 7, 4)).astype(np.float32))
    y_exact = np.asarray(predict(params, x, precision="exact"))
    y_fast = np.asarray(predict(params, x, precision="fast"))
    rel = np.linalg.norm(y_fast - y_exact) / np.linalg.norm(y_exact)
    assert rel < 3e-2
