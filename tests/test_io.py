"""CSV weight I/O: roundtrip + golden-load of the reference's shipped
model_weights fixtures (the 3×15-unit LabVIEW export)."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.io.csv_weights import (
    load_model_from_csv,
    save_model_weights_as_csv,
)
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply


class TestRoundtrip:
    def test_save_load(self, tmp_path):
        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
        save_model_weights_as_csv(params, str(tmp_path))
        loaded = load_model_from_csv(str(tmp_path), transposed=False)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


class TestOrbaxCheckpoint:
    def test_roundtrip_all_model_families(self, tmp_path):
        """Orbax checkpoints (SURVEY §5's checkpoint equivalent)
        must round-trip dense/singular/reduced pytrees exactly, restoring
        the NamedTuple structure without a template, and `load_params` must
        auto-detect the directory format."""
        import svd_lstm_tpu as st
        from svd_lstm_tpu.io.checkpoint import load_params, save_params_orbax

        params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=8, units=(6, 5))
        singular = st.make_singular_model(params, merged_kernel=False)
        reduced = st.make_reduced_model(singular, rank=3)
        for name, model in [("dense", params), ("singular", singular), ("reduced", reduced)]:
            path = str(tmp_path / name)
            save_params_orbax(path, model)
            restored = load_params(path)
            assert type(restored) is type(model)
            for a, b in zip(jax.tree.leaves(model), jax.tree.leaves(restored)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestGoldenFixtures:
    def test_load_reference_model_weights(self, reference_dir, rng):
        """The shipped lstm_{69,70,71} + dense_top CSVs must assemble into a
        runnable 3×15-unit, 16-input model (reference pasteboard.py:94 calls
        it '400us3cells15units')."""
        path = os.path.join(reference_dir, "code", "model_weights")
        params = load_model_from_csv(
            path, layer_dirs=["lstm_69", "lstm_70", "lstm_71"], transposed=True
        )
        assert len(params.layers) == 3
        assert params.layers[0].W.shape == (16, 60)
        assert params.layers[1].W.shape == (15, 60)
        assert params.layers[2].U.shape == (15, 60)
        assert params.head.w.shape == (15, 1)

        x = jnp.asarray(rng.normal(size=(1, 20, 16)), jnp.float32)
        y = stacked_lstm_apply(params, x)
        assert y.shape == (1, 20, 1)
        assert np.isfinite(np.asarray(y)).all()

    def test_reference_preprocessed_series_stats(self, reference_dir):
        """Golden sanity on the shipped preprocessed series: 400 µs clock,
        standardized pin signal."""
        t = np.loadtxt(
            os.path.join(reference_dir, "code", "preprocessed_DROPBEAR_t.csv"),
            delimiter=",",
        )
        y = np.loadtxt(
            os.path.join(reference_dir, "code", "preprocessed_DROPBEAR_y.csv"),
            delimiter=",",
        )
        assert t.shape == y.shape == (106450,)
        np.testing.assert_allclose(np.diff(t).mean(), 4e-4, rtol=1e-3)
        assert abs(y.mean()) < 1e-3 and abs(y.std() - 1.0) < 1e-3


class TestReferencePredictionParity:
    """Partial golden-parity against the reference's shipped
    ``model_prediction.csv``.

    Full replay is blocked upstream: the model input series
    ``preprocessed_DROPBEAR_X.csv`` was stripped as a large blob
    (reference .MISSING_LARGE_BLOBS:1), so the 3×15 model (whose weights DO
    ship, code/model_weights/) cannot be re-driven over the real test run.
    What CAN be checked without X, is checked here:

    * alignment — the prediction is exactly the t ≥ 30.7 s test split of the
      shipped frame-level series (29 700 frames at 400 µs);
    * the reference model's golden test metrics against the shipped ground
      truth, computed with OUR metric functions: RMSE 0.2029 (scaled units),
      SNR 12.43 dB, corr 0.963 — pinned so any metric-function or
      fixture-loading regression trips.
    """

    @pytest.fixture(scope="class")
    def golden(self, reference_dir):
        load = lambda n: np.loadtxt(
            os.path.join(reference_dir, "code", n), delimiter=","
        )
        return load("model_prediction.csv"), load("preprocessed_DROPBEAR_y.csv"), load(
            "preprocessed_DROPBEAR_t.csv"
        )

    def test_prediction_aligns_with_test_split(self, golden):
        pred, y, t = golden
        # same split rule as the pipeline: train/test boundary at t = 30.7 s
        # (reference code/train_full_model_v4.py:72-78)
        assert pred.shape == (29700,)
        assert int((t >= 30.7).sum()) == len(pred)
        assert np.isclose(np.diff(t).mean(), 400e-6, rtol=1e-3)

    def test_reference_model_golden_metrics(self, golden):
        from svd_lstm_tpu.train.metrics import rmse, signaltonoise

        pred, y, t = golden
        y_test = y[-len(pred):]
        assert np.isclose(rmse(y_test, pred), 0.20285, atol=2e-4)
        assert np.isclose(signaltonoise(y_test, pred), 12.434, atol=2e-2)
        assert np.corrcoef(pred, y_test)[0, 1] > 0.96
        # prediction lives in the same standardized space as the labels
        assert abs(pred.mean() - y_test.mean()) < 0.15
        assert abs(pred.std() - y_test.std()) < 0.15
