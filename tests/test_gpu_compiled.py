"""Compiled Triton kernels on the GPU (``@pytest.mark.gpu``).

Interpret-mode CPU tests cannot see what the GPU's compiler does: shared
memory and register limits, the dot lowering's precision, the grid. These
tests run the compiled kernels against the lax.scan reference at
``"highest"``. They skip off the GPU (decided in the ``gpu`` fixture);
``python chip_smoke.py`` runs them on the card, in its own process.

Tolerances: IEEE f32 ("highest") kernels differ from the scan only in
summation order — relative 1e-5 at T=200; TF32 ("default") keeps 10
mantissa bits — relative 1e-2.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import gate_update, init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.ops import gpu_recurrence as gr

pytestmark = pytest.mark.gpu

TOL = {"highest": 1e-5, "default": 1e-2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scan(xp, U):
    B, n = xp.shape[1], U.shape[0]

    def step(hc, x):
        h, c = gate_update(x + hc[0] @ U, hc[1])
        return (h, c), h

    zero = jnp.zeros((B, n), jnp.float32)
    return jax.lax.scan(step, (zero, zero), xp)[1]


def _case(n, B, T, seed=0):
    rng = np.random.default_rng(seed)
    xp = jnp.asarray(rng.normal(size=(T, B, 4 * n)), jnp.float32)
    U = jnp.asarray(rng.normal(size=(n, 4 * n)) / np.sqrt(n), jnp.float32)
    cot = jnp.asarray(rng.normal(size=(T, B, n)), jnp.float32)
    return xp, U, cot


@pytest.mark.parametrize(
    "n,B,precision",
    [(40, 1, "highest"), (40, 37, "highest"), (64, 16, "highest"),
     (40, 512, "default"), (128, 512, "default"), (8, 3, "default")],
)
def test_forward_matches_scan(gpu, n, B, precision):
    xp, U, _ = _case(n, B, 200)
    h = jax.jit(lambda a, u: gr.lstm_recurrence_fwd(a, u, precision)[0])(xp, U)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(_scan)(xp, U)
    assert _rel(h, ref) < TOL[precision]


@pytest.mark.parametrize("n,B,precision", [(40, 37, "highest"), (128, 64, "default")])
def test_gradients_match_scan_autodiff(gpu, n, B, precision):
    xp, U, cot = _case(n, B, 200, seed=1)
    g = jax.jit(jax.grad(
        lambda a, u: jnp.sum(gr.lstm_recurrence(a, u, precision) * cot), argnums=(0, 1)
    ))(xp, U)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.jit(jax.grad(lambda a, u: jnp.sum(_scan(a, u) * cot),
                                 argnums=(0, 1)))(xp, U)
    assert _rel(g[0], g_ref[0]) < TOL[precision]
    assert _rel(g[1], g_ref[1]) < TOL[precision]


@pytest.mark.parametrize("family", ["dense", "singular", "reduced"])
def test_predict_batch1_routes_to_kernel(gpu, family, monkeypatch):
    """On the GPU, predict(impl='auto') runs a narrow batch-1 model through
    the kernel (compiled), and agrees with the family's scan."""
    import svd_lstm_tpu as st

    params = init_stacked_lstm(jax.random.PRNGKey(0), 16, (40, 40))
    model, apply = params, st.stacked_lstm_apply
    if family != "dense":
        model = st.make_singular_model(params, merged_kernel=False)
        apply = st.singular_lstm_apply
    if family == "reduced":
        model = st.make_reduced_model(model, rank=25)
        apply = st.reduced_lstm_apply
    calls = {"n": 0}
    orig = gr.stack_forward

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(gr, "stack_forward", spy)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(512, 16)), jnp.float32)
    y = st.predict(model, x, consult_cache=False)
    assert calls["n"] == 1
    with jax.default_matmul_precision("highest"):
        ref = apply(model, x[None], return_sequences=True)[0]
    assert _rel(y, ref) < 1e-4  # one reconstruction rounding, 512 steps


def test_train_step_kernel_gradients(gpu):
    """The 4x40 training apply's parameter gradients (kernel pair at
    "highest") against scan autodiff."""
    params = init_stacked_lstm(jax.random.PRNGKey(1), 16, (40,) * 4)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(32, 200, 16)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(32,)), jnp.float32)

    def grads(apply):
        def loss(p):
            return jnp.mean((apply(p, x, return_sequences=False)[..., 0] - y) ** 2)

        return jax.jit(jax.grad(loss))(params)

    with jax.default_matmul_precision("highest"):
        g_ref = grads(stacked_lstm_apply)
        g = grads(lambda p, xx, return_sequences: gr.stacked_lstm_apply_fast_train(
            p, xx, return_sequences, precision="highest"))
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        assert _rel(a, b) < 1e-4
