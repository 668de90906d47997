"""Multi-device training loop (parallel/fit.py) ≡ the single-device fit.

Same window sampler, same seed, same optimizer: the dp-sharded epoch
program must reproduce train.loop.fit's loss history and final params to
f32 reduction-order noise, for the dense trainer AND the singular
fine-tune (the reference workflow's two training stages,
code/train_full_model_v4.py:98-126 / svd_acceleration_v3.py:119-128).
"""

import jax
import numpy as np
import pytest

from svd_lstm_tpu.config import FactorConfig, TrainConfig
from svd_lstm_tpu.factor.svd import make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.parallel.fit import finetune_dp, fit_dp
from svd_lstm_tpu.parallel.mesh import make_mesh
from svd_lstm_tpu.train.finetune import finetune
from svd_lstm_tpu.train.loop import fit


@pytest.fixture
def data(rng):
    X = rng.normal(size=(1, 96, 6)).astype(np.float32)
    y = rng.normal(size=(96,)).astype(np.float32)
    return X, y


CFG = dict(num_windows=32, window_len=8, batch_size=16, epochs=3, seed=11)


def test_fit_dp_matches_single_device(data):
    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=6, units=(10, 8))
    mesh = make_mesh(dp=8, tp=1)

    r_one = fit(params, X, y, cfg=TrainConfig(**CFG))
    r_dp = fit_dp(params, X, y, mesh, cfg=TrainConfig(**CFG))

    np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("kernel", [False, True])
def test_fit_dp_sgd_matches_single_device(data, kernel):
    """Under plain SGD the dp loop's gradient is exactly the single-device
    one, on the scan (vma-checked) and the kernel path alike — the mean
    over shards is taken once."""
    import optax

    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=6, units=(10,))
    mesh = make_mesh(dp=8, tp=1)
    cfg = TrainConfig(**{**CFG, "epochs": 2}, recurrence_kernel=kernel)
    r_one = fit(params, X, y, cfg=cfg, optimizer=optax.sgd(0.5))
    r_dp = fit_dp(params, X, y, mesh, cfg=cfg, optimizer=optax.sgd(0.5))
    np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_fit_dp_rejects_indivisible_batch(data):
    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=6, units=(8,))
    mesh = make_mesh(dp=8, tp=1)
    with pytest.raises(ValueError, match="divisible"):
        fit_dp(params, X, y, mesh, cfg=TrainConfig(**{**CFG, "batch_size": 12}))


def test_finetune_dp_matches_single_device(data):
    X, y = data
    dense = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=6, units=(8, 8))
    sparams = make_singular_model(dense, merged_kernel=False)
    fcfg = FactorConfig(hoyer=0.01)
    tcfg = TrainConfig(**CFG)
    mesh = make_mesh(dp=8, tp=1)

    r_one = finetune(sparams, X, y, factor_cfg=fcfg, train_cfg=tcfg)
    r_dp = finetune_dp(sparams, X, y, mesh, factor_cfg=fcfg, train_cfg=tcfg)

    np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_fit_dp_nan_rollback(data):
    """A poisoned epoch (NaN windows) rolls back params AND optimizer
    state, matching the single-device semantics (reference
    old_versions/train_full_model.py:125-136)."""
    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=6, units=(8,))
    mesh = make_mesh(dp=8, tp=1)
    rng = np.random.default_rng(0)
    Xw = rng.normal(size=(32, 8, 6)).astype(np.float32)
    yw = rng.normal(size=(32,)).astype(np.float32)
    yw_bad = yw.copy()
    yw_bad[:] = np.nan
    cfg = TrainConfig(**{**CFG, "epochs": 1})

    good = fit_dp(params, X, y, mesh, cfg=cfg, windows=(Xw, yw))
    bad = fit_dp(params, X, y, mesh, cfg=cfg, windows=(Xw, yw_bad))
    assert bad.rollbacks == 1 and bad.history == []
    for a, b in zip(jax.tree.leaves(bad.params), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)
    assert good.rollbacks == 0 and np.isfinite(good.history).all()


def test_fit_dp_honors_recurrence_kernel(data):
    """cfg.recurrence_kernel swaps the dp loop onto the recurrence kernel
    engine (interpret mode on CPU) and still matches the single-device
    kernel run."""
    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=6, units=(12, 12))
    mesh = make_mesh(dp=8, tp=1)
    cfg = TrainConfig(
        num_windows=64, window_len=6, batch_size=64, epochs=2, seed=3,
        recurrence_kernel=True,
    )
    r_one = fit(params, X, y, cfg=cfg)
    r_dp = fit_dp(params, X, y, mesh, cfg=cfg)
    np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_finetune_dp_dropout_runs(data):
    """FactorConfig.dropout is honored by the dp fine-tune (not silently
    dropped): the run is finite and its trajectory differs from the
    dropout-free run."""
    X, y = data
    dense = init_stacked_lstm(jax.random.PRNGKey(4), input_dim=6, units=(8,))
    sparams = make_singular_model(dense, merged_kernel=False)
    mesh = make_mesh(dp=8, tp=1)
    tcfg = TrainConfig(**CFG)
    r_plain = finetune_dp(sparams, X, y, mesh,
                          factor_cfg=FactorConfig(hoyer=0.01), train_cfg=tcfg)
    r_drop = finetune_dp(
        sparams, X, y, mesh,
        factor_cfg=FactorConfig(hoyer=0.01, dropout=0.4, recurrent_dropout=0.3),
        train_cfg=tcfg,
    )
    assert np.isfinite(r_drop.history).all()
    assert not np.allclose(r_drop.history, r_plain.history)


def test_fit_dp_validation_and_checkpoint(data, tmp_path):
    """validation + save-best checkpointing parity with fit (reference
    ModelCheckpoint/validation_data semantics)."""
    X, y = data
    params = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=6, units=(8,))
    mesh = make_mesh(dp=8, tp=1)
    ckpt = str(tmp_path / "best.npz")
    r = fit_dp(
        params, X, y, mesh, cfg=TrainConfig(**CFG),
        validation=(X, y), checkpoint_path=ckpt,
    )
    assert len(r.val_history) == len(r.history) == CFG["epochs"]
    assert np.isfinite(r.val_history).all()
    from svd_lstm_tpu.io.checkpoint import load_params

    best = load_params(ckpt)
    assert jax.tree.structure(best) == jax.tree.structure(params)


def test_finetune_dp_conv_hybrid_matches_single_device(data):
    """The dp fine-tune dispatches on the conv-hybrid family exactly like
    the single-device loop (shared dropout_apply_fn base dispatch)."""
    from svd_lstm_tpu.factor.svd import make_conv_singular_model
    from svd_lstm_tpu.models.conv import init_conv_lstm

    X, y = data
    hybrid = init_conv_lstm(
        jax.random.PRNGKey(2), in_channels=6, filters=8, kernel_size=5,
        units=(8, 8),
    )
    cs = make_conv_singular_model(hybrid)
    fcfg = FactorConfig(hoyer=0.01)
    tcfg = TrainConfig(**CFG)
    mesh = make_mesh(dp=8, tp=1)

    r_one = finetune(cs, X, y, factor_cfg=fcfg, train_cfg=tcfg)
    r_dp = finetune_dp(cs, X, y, mesh, factor_cfg=fcfg, train_cfg=tcfg)

    np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)
    # conv front end stayed frozen under sigma-only fine-tuning
    np.testing.assert_array_equal(
        np.asarray(r_dp.params.conv.w), np.asarray(cs.conv.w)
    )


def test_finetune_reduced_dp_matches_single_device(data):
    """The dp recovery fine-tune (beyond-reference: the reference's
    reduced cell is frozen, code/svd_classes_v3.py:249-315) reproduces
    the single-device finetune_reduced loop, including through the
    recurrence kernel pair (recurrence_kernel=True, interpret on CPU)."""
    from svd_lstm_tpu.factor.svd import make_reduced_model
    from svd_lstm_tpu.parallel.fit import finetune_reduced_dp
    from svd_lstm_tpu.train.finetune import finetune_reduced

    X, y = data
    dense = init_stacked_lstm(jax.random.PRNGKey(6), input_dim=6, units=(8, 8))
    rparams = make_reduced_model(make_singular_model(dense), rank=6)
    mesh = make_mesh(dp=8, tp=1)

    for kernel in (False, True):
        tcfg = TrainConfig(**CFG, recurrence_kernel=kernel)
        r_one = finetune_reduced(rparams, X, y, train_cfg=tcfg)
        r_dp = finetune_reduced_dp(rparams, X, y, mesh, train_cfg=tcfg)
        np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
        for a, b in zip(
            jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_finetune_reduced_dp_conv_hybrid(data):
    """Family dispatch: the conv-hybrid reduced model trains through the
    dp recovery loop — both the XLA scan and, since round 4, the fused
    recurrence kernel pair (ops/conv_train.py, interpret on CPU)."""
    from svd_lstm_tpu.factor.svd import (
        make_conv_reduced_model,
        make_conv_singular_model,
    )
    from svd_lstm_tpu.models.conv import init_conv_lstm
    from svd_lstm_tpu.parallel.fit import finetune_reduced_dp
    from svd_lstm_tpu.train.finetune import finetune_reduced

    X, y = data
    hybrid = init_conv_lstm(
        jax.random.PRNGKey(7), in_channels=6, filters=8, kernel_size=5,
        units=(8,),
    )
    cr = make_conv_reduced_model(make_conv_singular_model(hybrid), rank=6)
    mesh = make_mesh(dp=8, tp=1)

    for kernel in (False, True):
        tcfg = TrainConfig(**CFG, recurrence_kernel=kernel)
        r_one = finetune_reduced(cr, X, y, train_cfg=tcfg)
        r_dp = finetune_reduced_dp(cr, X, y, mesh, train_cfg=tcfg)
        np.testing.assert_allclose(r_dp.history, r_one.history, rtol=1e-4)
        for a, b in zip(
            jax.tree.leaves(r_dp.params), jax.tree.leaves(r_one.params)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)
