"""Validation tracking, best-checkpointing, and a CPU bench smoke."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax

from svd_lstm_tpu.config import TrainConfig
from svd_lstm_tpu.io.checkpoint import load_params
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.train.loop import fit


@pytest.fixture(scope="module")
def tiny_run():
    rng = np.random.default_rng(3)
    T, d = 400, 4
    x = rng.normal(size=(T, d)).astype(np.float32)
    kernel = np.exp(-np.arange(10) / 4.0)
    y = np.convolve(x[:, 0], kernel / kernel.sum(), mode="same").astype(np.float32)
    return x[None], y


def test_validation_and_checkpoint(tmp_path, tiny_run):
    X, y = tiny_run
    params = init_stacked_lstm(jax.random.PRNGKey(0), 4, (8,))
    ckpt = str(tmp_path / "best.npz")
    res = fit(
        params, X, y,
        TrainConfig(num_windows=128, window_len=20, epochs=3, batch_size=32),
        validation=(X, y),
        checkpoint_path=ckpt,
    )
    assert len(res.val_history) == 3
    assert os.path.exists(ckpt)
    best = load_params(ckpt)
    assert type(best) is type(res.params)


def test_validation_multi_sequence(tiny_run):
    """A validation set of SEVERAL runs must work — the old yv.reshape(1,-1)
    broadcast against a (B, T) prediction and crashed for B > 1. The mean
    MSE must also equal the B=1 computation run per-sequence."""
    X, y = tiny_run
    params = init_stacked_lstm(jax.random.PRNGKey(0), 4, (8,))
    Xv = np.concatenate([X, X * 0.5], axis=0)          # (2, T, d)
    yv = np.stack([y, 0.5 * y], axis=0)                # (2, T)
    cfg = TrainConfig(num_windows=64, window_len=20, epochs=1, batch_size=32)
    res = fit(params, X, y, cfg, validation=(Xv, yv))
    assert len(res.val_history) == 1 and np.isfinite(res.val_history[0])
    a = fit(params, X, y, cfg, validation=(Xv[:1], yv[:1])).val_history[0]
    b = fit(params, X, y, cfg, validation=(Xv[1:], yv[1:])).val_history[0]
    np.testing.assert_allclose(res.val_history[0], (a + b) / 2, rtol=1e-5)


def test_jit_epoch_matches_per_step(tiny_run):
    """Epoch-level scan must reproduce the per-step loop bitwise (same
    shuffle, same updates)."""
    X, y = tiny_run
    params = init_stacked_lstm(jax.random.PRNGKey(1), 4, (8,))
    cfg = TrainConfig(num_windows=128, window_len=20, epochs=2, batch_size=32, seed=7)
    a = fit(params, X, y, cfg, jit_epoch=False)
    b = fit(params, X, y, cfg, jit_epoch=True)
    np.testing.assert_allclose(a.history, b.history, rtol=1e-6)
    for x1, x2 in zip(
        __import__("jax").tree.leaves(a.params), __import__("jax").tree.leaves(b.params)
    ):
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-6)


def test_bench_cpu_smoke():
    """bench.py measures the GPU only: on the CPU it exits non-zero and
    prints no result line."""
    from conftest import subprocess_env

    env = subprocess_env(JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..", "bench.py")],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "measures the GPU" in out.stderr


def test_fit_rejects_zero_step_epochs(tiny_run):
    """num_windows < batch_size means zero steps per epoch; the old code
    scanned nothing, mean([]) was NaN and the rollback silently no-op'd the
    whole run. Must raise instead."""
    X, y = tiny_run
    params = init_stacked_lstm(jax.random.PRNGKey(0), 4, (8,))
    cfg = TrainConfig(num_windows=16, window_len=20, epochs=1, batch_size=32)
    with pytest.raises(ValueError, match="zero steps"):
        fit(params, X, y, cfg)


# --------------------------------------------- gated wide recovery --
# No fixed recovery LR is rank-robust at 3x512 (r=48/24
# diverged under the round-4 'measured-stable' 3e-5). recover_reduced_gated
# replaces the fixed recipe with a val-gated lr-backoff procedure that is
# monotone in validation MSE by construction.


@pytest.fixture(scope="module")
def tiny_reduced(tiny_run):
    """A briefly-trained dense model truncated aggressively (rank 2 of 8)
    so raw truncation leaves real damage for the recovery to repair."""
    import svd_lstm_tpu as st

    X, y = tiny_run
    params = fit(
        init_stacked_lstm(jax.random.PRNGKey(1), 4, (8, 8)),
        X, y, _gate_cfg(epochs=3),
    ).params
    smodel = st.make_singular_model(params, merged_kernel=True)
    return st.make_reduced_model(smodel, cutoff=None, rank=2)


def _gate_cfg(epochs=1):
    return TrainConfig(
        num_windows=64, window_len=20, batch_size=8, seed=0, epochs=epochs
    )


def test_gated_recovery_never_worse_than_raw(tiny_run, tiny_reduced):
    """A ladder that STARTS with a catastrophically diverging LR: the
    first epoch is rejected (rolled back), the ladder steps down, and the
    returned params are never worse than raw truncation on the gate."""
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.train.finetune import recover_reduced_gated
    from svd_lstm_tpu.train.loop import make_val_fn

    X, y = tiny_run
    out, info = recover_reduced_gated(
        tiny_reduced, X, y, train_cfg=_gate_cfg(),
        lr_ladder=(50.0, 1e-2), clip=1e9, max_epochs=3,
    )
    val_fn = make_val_fn(reduced_lstm_apply, (X, y))
    assert float(val_fn(out)) <= float(val_fn(tiny_reduced)) + 1e-9
    assert info["trace"][0]["accepted"] is False  # lr=50 diverged, rejected
    assert info["best_val_mse"] <= info["raw_val_mse"] + 1e-9


def test_gated_recovery_improves_when_stable(tiny_run, tiny_reduced):
    from svd_lstm_tpu.train.finetune import recover_reduced_gated

    X, y = tiny_run
    out, info = recover_reduced_gated(
        tiny_reduced, X, y, train_cfg=_gate_cfg(),
        lr_ladder=(3e-3,), max_epochs=3,
    )
    assert info["accepted_epochs"] >= 1
    assert info["best_val_mse"] < info["raw_val_mse"]
    # provenance stamp for the artifact
    assert info["lr_ladder"] == [3e-3] and "clip" in info


def test_progressive_truncate_recover(tiny_run):
    """truncate_recover_progressive walks a descending schedule, gating
    each stage; the result has the final rank and never regresses the
    gate metric (round-5 r=24 rescue mechanism)."""
    import svd_lstm_tpu as st
    from svd_lstm_tpu.train.finetune import truncate_recover_progressive

    X, y = tiny_run
    params = fit(
        init_stacked_lstm(jax.random.PRNGKey(1), 4, (8, 8)),
        X, y, _gate_cfg(epochs=3),
    ).params
    rmod, infos = truncate_recover_progressive(
        params, X, y, ranks=(4, 2), train_cfg=_gate_cfg(),
        lr_ladder=(3e-3,), max_epochs=2,
    )
    assert [i["rank"] for i in infos] == [4, 2]
    assert all(l.wB.shape[1] == 2 for l in rmod.layers)  # final rank held
    for i in infos:
        assert i["best_val_mse"] <= i["raw_val_mse"] + 1e-9

    with pytest.raises(ValueError):
        truncate_recover_progressive(params, X, y, ranks=(2, 4))
