"""Kernel execution layouts: singular/reduced dense-collapse through the
recurrence kernel (``predict(impl="fused")``, interpret mode on the CPU).
5e-5 on O(1) outputs bounds the collapse's one rounding per weight."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.api import predict
from svd_lstm_tpu.models.singular import singular_lstm_apply
from svd_lstm_tpu.ops.layouts import reconstruct_dense_model


@pytest.fixture(scope="module")
def dense():
    return init_stacked_lstm(jax.random.PRNGKey(11), input_dim=8, units=(12, 12))


@pytest.fixture(scope="module")
def x(rng_mod=np.random.default_rng(12)):
    return jnp.asarray(rng_mod.normal(size=(40, 8)), jnp.float32)


def test_singular_fused_matches_scan(dense, x):
    smodel = make_singular_model(dense, merged_kernel=False)
    ref = np.asarray(singular_lstm_apply(smodel, x[None]))[0]
    got = np.asarray(predict(smodel, x, impl="fused"))
    np.testing.assert_allclose(got, ref, atol=5e-5)


@pytest.mark.parametrize("merged", [True, False])
def test_reduced_fused_matches_scan(dense, x, merged):
    rmodel = make_reduced_model(make_singular_model(dense, merged_kernel=merged), rank=5)
    ref = np.asarray(reduced_lstm_apply(rmodel, x[None]))[0]
    got = np.asarray(predict(rmodel, x, impl="fused"))
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_reconstruct_dense_model_exact(dense, x):
    rmodel = make_reduced_model(make_singular_model(dense, merged_kernel=False), cutoff=0.0)
    back = reconstruct_dense_model(rmodel)
    # cutoff=0 keeps every sigma -> reconstruction equals the original model
    y1 = np.asarray(stacked_lstm_apply(dense, x[None]))
    y2 = np.asarray(stacked_lstm_apply(back, x[None]))
    np.testing.assert_allclose(y2, y1, atol=5e-4)
