"""High-level predict() dispatch."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import svd_lstm_tpu as st
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply


@pytest.fixture(scope="module")
def models():
    dense = init_stacked_lstm(jax.random.PRNGKey(0), 6, (10, 10))
    smodel = st.make_singular_model(dense, merged_kernel=True)
    rmodel = st.make_reduced_model(smodel, rank=4)
    return dense, smodel, rmodel


def test_predict_batch1_and_batched(models, rng):
    dense, smodel, rmodel = models
    x1 = jnp.asarray(rng.normal(size=(30, 6)), jnp.float32)
    xb = jnp.asarray(rng.normal(size=(3, 30, 6)), jnp.float32)
    for m in models:
        y1 = st.predict(m, x1)
        yb = st.predict(m, xb)
        assert y1.shape == (30, 1)
        assert yb.shape == (3, 30, 1)

    # dense predict == scan reference
    ref = stacked_lstm_apply(dense, x1[None])[0]
    np.testing.assert_allclose(np.asarray(st.predict(dense, x1)), np.asarray(ref), atol=1e-5)


def test_predict_consistency_across_model_forms(models, rng):
    """singular == dense; reduced(rank 4) close to dense."""
    dense, smodel, rmodel = models
    x1 = jnp.asarray(rng.normal(size=(25, 6)), jnp.float32)
    yd = np.asarray(st.predict(dense, x1))
    ys = np.asarray(st.predict(smodel, x1))
    np.testing.assert_allclose(ys, yd, atol=1e-4)


def test_predict_rejects_unknown():
    with pytest.raises(TypeError):
        st.predict({"not": "a model"}, jnp.zeros((4, 2)))


def test_predict_precision_modes(models, rng):
    """Batched throughput precision modes: 'high' is near-exact, 'fast'
    (bf16) is bounded-error, both return f32 and preserve shape; batch-1
    ignores the flag (reduced precision doesn't pay at batch 1 — api.py
    module docstring records the measurements)."""
    dense, _, rmodel = models
    xb = jnp.asarray(rng.normal(size=(3, 30, 6)), jnp.float32)
    x1 = jnp.asarray(rng.normal(size=(30, 6)), jnp.float32)
    # fast/bf16 tolerance is loose here: random untrained weights produce
    # near-zero outputs, inflating relative error
    for m, fast_tol in ((dense, 5e-2), (rmodel, 0.25)):
        ref = np.asarray(st.predict(m, xb))
        scale = np.abs(ref).max()
        hi = st.predict(m, xb, precision="high")
        fa = st.predict(m, xb, precision="fast")
        assert hi.dtype == jnp.float32 and fa.dtype == jnp.float32
        assert hi.shape == ref.shape and fa.shape == ref.shape
        assert np.abs(np.asarray(hi) - ref).max() / scale < 1e-3
        assert np.abs(np.asarray(fa) - ref).max() / scale < fast_tol
    # batch-1: flag accepted, result unchanged
    np.testing.assert_allclose(
        np.asarray(st.predict(dense, x1, precision="fast")),
        np.asarray(st.predict(dense, x1)),
        atol=1e-6,
    )
    with pytest.raises(ValueError):
        st.predict(dense, xb, precision="int3")


def test_predict_rejects_bad_args(models, rng):
    dense, _, _ = models
    x1 = jnp.asarray(rng.normal(size=(10, 6)), jnp.float32)
    xb = jnp.asarray(rng.normal(size=(2, 10, 6)), jnp.float32)
    with pytest.raises(ValueError):  # batch-1 input must also validate precision
        st.predict(dense, x1, precision="bogus")
    with pytest.raises(ValueError):  # the batch-1 kernel refuses batched input
        st.predict(dense, xb, impl="fused")
    with pytest.raises(ValueError, match="unknown impl"):  # removed with its kernel
        st.predict(dense, x1, impl="hybrid")
    # explicit 'fused' on a wide model must refuse, not silently run the
    # scan under the wrong label
    wide = init_stacked_lstm(jax.random.PRNGKey(9), input_dim=6, units=(256,))
    with pytest.raises(ValueError, match="MAX_UNITS"):
        st.predict(wide, jnp.zeros((4, 6)), impl="fused")


def test_predict_traces_under_jit_for_every_family(models, rng):
    """predict must be jittable for every model family (the CLI trace
    command, bench.autotune and user code all wrap it in jax.jit).
    Regression: singular models reached a numpy-based singular_to_dense on
    the fast/fused routes and died with TracerArrayConversionError."""
    dense, smodel, rmodel = models
    xb = jnp.asarray(rng.normal(size=(2, 12, 6)), jnp.float32)
    for m in models:
        fn = jax.jit(lambda p, x: st.predict(p, x, impl="scan", precision="fast"))
        y = fn(m, xb)
        assert y.shape == (2, 12, 1) and bool(jnp.all(jnp.isfinite(y)))


@pytest.mark.parametrize("merged", [True, False])
def test_singular_to_dense_jit_parity(merged, rng):
    """singular_to_dense is pure jnp: identical traced and host-side."""
    from svd_lstm_tpu.factor.svd import singular_to_dense

    dense = init_stacked_lstm(jax.random.PRNGKey(3), 5, (8, 7))
    smodel = st.make_singular_model(dense, merged_kernel=merged)
    host = singular_to_dense(smodel)
    traced = jax.jit(singular_to_dense)(smodel)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(traced)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)
    # and the reconstruction is still the inverse of the factorization
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(dense)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
