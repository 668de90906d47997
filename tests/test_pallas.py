"""Recurrence kernel (ops/gpu_recurrence.py) forward vs the XLA scan
reference, whole stacks, in interpret mode on the CPU (the compiled Triton
kernels are checked on the card by tests/test_gpu_compiled.py). CPU dots
are exact f32, so 2e-5 on O(1) outputs bounds summation-order roundoff
through two layers and the reduced model's one reconstruction rounding."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.ops.gpu_recurrence import stack_forward
from svd_lstm_tpu.ops.layouts import reconstruct_dense_model


@pytest.fixture(scope="module")
def dense_model():
    return init_stacked_lstm(jax.random.PRNGKey(5), input_dim=16, units=(24, 24))


@pytest.fixture(scope="module")
def x_run(rng_mod=np.random.default_rng(11)):
    return jnp.asarray(rng_mod.normal(size=(50, 16)), jnp.float32)


class TestFusedStacks:
    def test_fused_dense_matches_scan(self, dense_model, x_run):
        ref = np.asarray(stacked_lstm_apply(dense_model, x_run[None]))[0]
        ours = np.asarray(stack_forward(dense_model, x_run))
        np.testing.assert_allclose(ours, ref, atol=2e-5)

    @pytest.mark.parametrize("merged", [True, False])
    def test_fused_reduced_matches_scan(self, dense_model, x_run, merged):
        """Reduced models reach the kernel through their exact dense
        reconstruction; the reference is the two-step scan."""
        rmodel = make_reduced_model(
            make_singular_model(dense_model, merged_kernel=merged), rank=10
        )
        ref = np.asarray(reduced_lstm_apply(rmodel, x_run[None]))[0]
        ours = np.asarray(stack_forward(reconstruct_dense_model(rmodel), x_run))
        np.testing.assert_allclose(ours, ref, atol=2e-5)
