"""Streaming single-step API + singular→dense collapse."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.factor.svd import (
    make_reduced_model,
    make_singular_model,
    singular_to_dense,
)
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.models.singular import singular_lstm_apply
from svd_lstm_tpu.models.streaming import init_stream, stream_many, stream_step


@pytest.fixture(scope="module")
def dense():
    return init_stacked_lstm(jax.random.PRNGKey(3), input_dim=6, units=(10, 10))


@pytest.fixture(scope="module")
def x(rng_mod=np.random.default_rng(4)):
    return jnp.asarray(rng_mod.normal(size=(1, 25, 6)), jnp.float32)


class TestStreaming:
    def test_dense_stream_matches_batch(self, dense, x):
        ref = np.asarray(stacked_lstm_apply(dense, x))[0]
        state = init_stream(dense)
        outs = []
        step = jax.jit(stream_step)
        for t in range(x.shape[1]):
            y, state = step(dense, state, x[:, t])
            outs.append(np.asarray(y)[0])
        np.testing.assert_allclose(np.stack(outs), ref, atol=1e-5)

    @pytest.mark.parametrize("kind", ["singular", "reduced"])
    def test_factorized_stream_matches_batch(self, dense, x, kind):
        smodel = make_singular_model(dense, merged_kernel=False)
        if kind == "singular":
            model, apply_fn = smodel, singular_lstm_apply
        else:
            model = make_reduced_model(smodel, rank=4)
            apply_fn = reduced_lstm_apply
        ref = np.asarray(apply_fn(model, x))[0]
        ys, _ = stream_many(model, init_stream(model), x)
        np.testing.assert_allclose(np.asarray(ys)[0], ref, atol=1e-5)

    def test_state_carries_across_chunks(self, dense, x):
        full, _ = stream_many(dense, init_stream(dense), x)
        a, st = stream_many(dense, init_stream(dense), x[:, :10])
        b, _ = stream_many(dense, st, x[:, 10:])
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate([a, b], axis=1)), np.asarray(full), atol=1e-6
        )


class TestSingularToDense:
    @pytest.mark.parametrize("merged", [True, False])
    def test_roundtrip_exact(self, dense, x, merged):
        smodel = make_singular_model(dense, merged_kernel=merged)
        back = singular_to_dense(smodel)
        for a, b in zip(jax.tree.leaves(dense), jax.tree.leaves(back)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
        y1 = stacked_lstm_apply(dense, x)
        y2 = stacked_lstm_apply(back, x)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-5)


def test_make_stream_fn_matches_stream_step(rng):
    """Pre-packed streaming closure ≡ stream_step for all three families
    (round-3 review: packing hoisted out of the per-frame path)."""
    import svd_lstm_tpu as st
    from svd_lstm_tpu.models.lstm import init_stacked_lstm
    from svd_lstm_tpu.models.streaming import (
        init_stream,
        make_stream_fn,
        stream_step,
    )

    dense = init_stacked_lstm(jax.random.PRNGKey(21), input_dim=5, units=(8, 6))
    sing = st.make_singular_model(dense, merged_kernel=False)
    red = st.make_reduced_model(sing, rank=4)
    for params in (dense, sing, red):
        fn, state_p = make_stream_fn(params)
        state_r = init_stream(params)
        for t in range(5):
            frame = jnp.asarray(rng.normal(size=(1, 5)).astype(np.float32))
            y_p, state_p = fn(state_p, frame)
            y_r, state_r = stream_step(params, state_r, frame)
            np.testing.assert_allclose(np.asarray(y_p), np.asarray(y_r), atol=1e-5)


def test_realtime_stream_example_smoke():
    """examples/realtime_stream.py drives the deployment consumer loop
    (JAX frame-at-a-time + chunked + native C++) end-to-end with parity
    asserts inside the script."""
    import os
    import subprocess
    import sys

    from conftest import REPO_DIR, subprocess_env

    env = subprocess_env(JAX_PLATFORMS="cpu")
    script = os.path.join(REPO_DIR, "examples", "realtime_stream.py")
    out = subprocess.run(
        [sys.executable, script, "--quick", "--units", "8,8", "--rank", "5",
         "--frames", "96"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "realtime streaming demo OK" in out.stdout or (
        "native runtime unavailable" in out.stdout
    ), out.stdout[-2000:]
