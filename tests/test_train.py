"""Training loop, fine-tune gradient routing, NaN rollback, checkpointing."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.config import FactorConfig, TrainConfig
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io.checkpoint import load_params, save_params
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.train.finetune import finetune, harvest_sigmas, regularization_loss
from svd_lstm_tpu.train.loop import fit, predict_full_run


@pytest.fixture(scope="module")
def tiny_run():
    """A learnable synthetic run: y = smoothed first feature."""
    rng = np.random.default_rng(3)
    T, d = 600, 4
    x = rng.normal(size=(T, d)).astype(np.float32)
    kernel = np.exp(-np.arange(20) / 5.0)
    y = np.convolve(x[:, 0], kernel / kernel.sum(), mode="same").astype(np.float32)
    return x[None], y


def _small_cfg(**kw):
    base = dict(num_windows=256, window_len=20, batch_size=32, epochs=3, seed=0)
    base.update(kw)
    return TrainConfig(**base)


class TestFit:
    def test_loss_decreases(self, tiny_run):
        X, y = tiny_run
        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(8,))
        res = fit(params, X, y, cfg=_small_cfg(epochs=4))
        assert len(res.history) == 4
        assert res.history[-1] < res.history[0]
        assert res.rollbacks == 0

    @pytest.mark.parametrize("prec", ["tensorfloat32", "bfloat16"])
    def test_matmul_precision_trains(self, tiny_run, prec):
        """Relaxed train-step matmul passes (TF32, bf16) must converge like
        the exact default."""
        X, y = tiny_run
        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(8,))
        res = fit(params, X, y, cfg=_small_cfg(epochs=4, matmul_precision=prec))
        assert res.rollbacks == 0
        assert np.isfinite(res.history).all()
        assert res.history[-1] < res.history[0]

    def test_nan_rollback_restores_params(self, tiny_run):
        X, y = tiny_run
        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(8,))
        res = fit(
            params, X, y, cfg=_small_cfg(epochs=2),
            loss_extra=lambda p: jnp.float32(jnp.nan),
        )
        # every epoch NaNs out -> rolled back each time, params preserved
        assert res.rollbacks == 2
        assert res.history == []
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(res.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_nan_rollback_restores_optimizer_state(self):
        """A rollback must restore the adam moments
        snapshotted with the last good params, not reinitialize them to zero
        (the reference's in-process Keras checkpoint reload keeps optimizer
        state, old_versions/train_full_model.py:133-136).

        Fault injection: one poisoned window (NaN target) that epoch 0's
        batch-truncation permutation drops and epoch 1's includes, so epoch
        0 trains cleanly (nonzero moments) and epoch 1 NaNs out.
        """
        n_win, T, d, bs, seed = 9, 10, 2, 4, 0
        dropped0 = int(np.random.default_rng(seed + 0).permutation(n_win)[-1])
        dropped1 = int(np.random.default_rng(seed + 1).permutation(n_win)[-1])
        assert dropped0 != dropped1, "pick another seed"

        rng = np.random.default_rng(7)
        X_mini = rng.normal(size=(n_win, T, d)).astype(np.float32)
        y_mini = rng.normal(size=(n_win,)).astype(np.float32)
        y_poisoned = y_mini.copy()
        y_poisoned[dropped0] = np.nan

        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=d, units=(8,))
        dummy_X, dummy_y = np.zeros((1, 2 * T, d), np.float32), np.zeros(2 * T, np.float32)
        cfg1 = _small_cfg(epochs=1, batch_size=bs, seed=seed)
        cfg2 = _small_cfg(epochs=2, batch_size=bs, seed=seed)

        ref = fit(params, dummy_X, dummy_y, cfg=cfg1, windows=(X_mini, y_poisoned))
        res = fit(params, dummy_X, dummy_y, cfg=cfg2, windows=(X_mini, y_poisoned))

        assert res.rollbacks == 1 and len(res.history) == 1
        assert np.isclose(res.history[0], ref.history[0])
        # params rolled back to the post-epoch-0 state
        for a, b in zip(jax.tree.leaves(ref.params), jax.tree.leaves(res.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # adam moments survived the rollback (and are genuinely nonzero)
        ref_leaves = jax.tree.leaves(ref.opt_state)
        res_leaves = jax.tree.leaves(res.opt_state)
        assert any(np.abs(np.asarray(l)).max() > 0 for l in ref_leaves)
        for a, b in zip(ref_leaves, res_leaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_predict_full_run_shape(self, tiny_run):
        X, y = tiny_run
        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(8,))
        pred = predict_full_run(params, X)
        assert pred.shape == (X.shape[1],)
        assert np.isfinite(pred).all()


class TestFinetune:
    @pytest.fixture(scope="class")
    def smodel(self):
        dense = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=4, units=(8, 8))
        return make_singular_model(dense, merged_kernel=False)

    def test_sigma_only_updates(self, smodel, tiny_run):
        X, y = tiny_run
        cfg = FactorConfig(hoyer=0.01, orthogonal=0.0, train_uv=False)
        res = finetune(smodel, X, y, cfg, TrainConfig(num_windows=64, window_len=20, epochs=1))
        new = res.params
        for old_l, new_l in zip(smodel.layers, new.layers):
            # frozen: factors + bias
            for f in ("wl", "wr", "ul", "ur", "b"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(old_l, f)), np.asarray(getattr(new_l, f))
                )
            # trained: sigmas
            assert not np.allclose(np.asarray(old_l.ws), np.asarray(new_l.ws))
            assert not np.allclose(np.asarray(old_l.us), np.asarray(new_l.us))

    def test_train_uv_updates_factors(self, smodel, tiny_run):
        X, y = tiny_run
        cfg = FactorConfig(hoyer=0.01, orthogonal=0.01)  # orthogonal>0 => train_uv
        res = finetune(smodel, X, y, cfg, TrainConfig(num_windows=64, window_len=20, epochs=1))
        l0_old, l0_new = smodel.layers[0], res.params.layers[0]
        assert not np.allclose(np.asarray(l0_old.wl), np.asarray(l0_new.wl))

    def test_regularization_loss_finite_positive(self, smodel):
        val = float(regularization_loss(smodel, FactorConfig(hoyer=0.01, orthogonal=0.01)))
        assert np.isfinite(val) and val > 0

    def test_harvest_sigmas(self, smodel):
        sigmas = harvest_sigmas(smodel)
        assert len(sigmas) == 2
        assert sigmas[0][0].shape == (4, 4)   # split: (gates, k=min(d,n))
        assert sigmas[0][1].shape == (4, 8)


class TestCheckpoint:
    @pytest.mark.parametrize("kind", ["dense", "singular", "reduced"])
    def test_roundtrip(self, tmp_path, kind):
        dense = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=4, units=(6, 6))
        if kind == "dense":
            params = dense
        elif kind == "singular":
            params = make_singular_model(dense, merged_kernel=False)
        else:
            params = make_reduced_model(
                make_singular_model(dense, merged_kernel=False), rank=3
            )
        path = str(tmp_path / f"{kind}.npz")
        save_params(path, params)
        loaded = load_params(path)
        assert type(loaded) is type(params)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
