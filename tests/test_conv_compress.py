"""Compressed conv-hybrid family: surgery exactness and fine-tune routing.

The reference never composes its conv experiment
(code/old_versions/toy-convolution.py:70-76) with the compression pipeline
(code/svd_classes_v3.py:469-676); these tests pin the rebuilt framework's
square-closing guarantee — the hybrid factorizes, truncates, fine-tunes and
collapses back to dense with the same exactness contracts as the pure-LSTM
family.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.config import FactorConfig, TrainConfig
from svd_lstm_tpu.factor.svd import (
    conv_singular_to_dense,
    make_conv_reduced_model,
    make_conv_singular_model,
)
from svd_lstm_tpu.models.conv import (
    conv_lstm_apply,
    conv_reduced_apply,
    conv_singular_apply,
    init_conv_lstm,
)
from svd_lstm_tpu.train.finetune import finetune, harvest_sigmas


@pytest.fixture(scope="module")
def hybrid():
    return init_conv_lstm(
        jax.random.PRNGKey(7), in_channels=1, filters=8, kernel_size=5, units=(8, 8)
    )


@pytest.fixture(scope="module")
def x(rng_module):
    return jnp.asarray(rng_module.normal(size=(3, 24, 1)), jnp.float32)


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(11)


class TestHybridSurgery:
    @pytest.mark.parametrize("merged", [False, True])
    def test_factorization_exact(self, hybrid, x, merged):
        """conv+singular ≡ conv+dense at full rank (SVD is exact)."""
        cs = make_conv_singular_model(hybrid, merged_kernel=merged)
        y_dense = np.asarray(conv_lstm_apply(hybrid, x))
        y_sing = np.asarray(conv_singular_apply(cs, x))
        np.testing.assert_allclose(y_sing, y_dense, atol=2e-5)

    def test_full_rank_truncation_exact(self, hybrid, x):
        """Two-step at full rank reproduces the singular model."""
        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=8)
        y_sing = np.asarray(conv_singular_apply(cs, x))
        y_red = np.asarray(conv_reduced_apply(cr, x))
        np.testing.assert_allclose(y_red, y_sing, atol=2e-5)

    def test_dense_collapse_roundtrip(self, hybrid, x):
        """conv_singular_to_dense inverts make_conv_singular_model."""
        cs = make_conv_singular_model(hybrid)
        back = conv_singular_to_dense(cs)
        y0 = np.asarray(conv_lstm_apply(hybrid, x))
        y1 = np.asarray(conv_lstm_apply(back, x))
        np.testing.assert_allclose(y1, y0, atol=2e-5)
        # conv front end passes through bit-exact
        np.testing.assert_array_equal(np.asarray(back.conv.w), np.asarray(hybrid.conv.w))

    def test_truncation_shrinks_weight_count(self, hybrid):
        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=3)
        full = int(sum(x_.size for x_ in jax.tree_util.tree_leaves(hybrid)))
        assert cr.weight_count() < full

    def test_type_guards(self, hybrid):
        cs = make_conv_singular_model(hybrid)
        with pytest.raises(TypeError):
            make_conv_singular_model(cs)
        with pytest.raises(TypeError):
            make_conv_reduced_model(hybrid, rank=2)
        with pytest.raises(TypeError):
            conv_singular_to_dense(hybrid)


class TestHybridStreaming:
    """Frame-at-a-time streaming of the conv families: the ring-buffer conv
    front end (zero-initialized = causal left padding) must reproduce the
    whole-sequence forward exactly."""

    def _families(self, hybrid):
        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=4)
        return [
            (hybrid, conv_lstm_apply),
            (cs, conv_singular_apply),
            (cr, conv_reduced_apply),
        ]

    def test_stream_many_matches_batch(self, hybrid, x):
        from svd_lstm_tpu.models.streaming import init_stream, stream_many

        for params, apply_fn in self._families(hybrid):
            ref = np.asarray(apply_fn(params, x))[0]
            ys, _ = stream_many(params, init_stream(params, batch=x.shape[0]), x)
            np.testing.assert_allclose(np.asarray(ys)[0], ref, atol=1e-5)

    def test_state_carries_across_chunks(self, hybrid, x):
        from svd_lstm_tpu.models.streaming import init_stream, stream_many

        full, _ = stream_many(hybrid, init_stream(hybrid, batch=x.shape[0]), x)
        a, st = stream_many(hybrid, init_stream(hybrid, batch=x.shape[0]), x[:, :10])
        b, _ = stream_many(hybrid, st, x[:, 10:])
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate([a, b], axis=1)), np.asarray(full), atol=1e-6
        )

    def test_make_stream_fn_matches_stream_step(self, hybrid, rng_module):
        from svd_lstm_tpu.models.streaming import (
            init_stream,
            make_stream_fn,
            stream_step,
        )

        for params, _ in self._families(hybrid):
            fn, state_p = make_stream_fn(params)
            state_r = init_stream(params)
            for _t in range(5):
                frame = jnp.asarray(
                    rng_module.normal(size=(1, 1)).astype(np.float32)
                )
                y_p, state_p = fn(state_p, frame)
                y_r, state_r = stream_step(params, state_r, frame)
                np.testing.assert_allclose(
                    np.asarray(y_p), np.asarray(y_r), atol=1e-5
                )


class TestHybridPredict:
    """api.predict peels the conv front end and routes the inner stack."""

    def test_predict_matches_apply(self, hybrid, x):
        from svd_lstm_tpu.api import predict

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=4)
        for params, apply_fn in (
            (hybrid, conv_lstm_apply),
            (cs, conv_singular_apply),
            (cr, conv_reduced_apply),
        ):
            ref = np.asarray(apply_fn(params, x))
            out = np.asarray(predict(params, x))  # batched
            np.testing.assert_allclose(out, ref, atol=1e-5)
            out1 = np.asarray(predict(params, x[0]))  # batch-1 (T, d)
            np.testing.assert_allclose(out1, ref[0], atol=1e-5)

    def test_valid_impls_unwraps_hybrid(self, hybrid, x):
        from svd_lstm_tpu.api import valid_impls

        cs = make_conv_singular_model(hybrid)
        assert "fused" in valid_impls(cs, x[0])
        assert valid_impls(cs, x) == ["scan"]


class TestHybridCheckpoint:
    def test_npz_roundtrip_all_families(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.checkpoint import load_params, save_params

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=4)
        for i, params in enumerate((hybrid, cs, cr)):
            p = str(tmp_path / f"ckpt_{i}.npz")
            save_params(p, params)
            back = load_params(p)
            assert type(back) is type(params)
            for a, b in zip(
                jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)
            ):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestHybridExportNative:
    """CSV / int8 export of the conv hybrids and native C++ consumer parity.

    The deployment square for the hybrid family: the runtime streams the
    conv front end through a shift buffer (svdlstm_runtime.cpp conv_step)
    whose zero init equals the causal left padding."""

    def _frames(self, T=40):
        return np.random.default_rng(3).normal(size=(T, 1)).astype(np.float32)

    def test_csv_roundtrip_returns_hybrid(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.csv_weights import (
            load_model_from_csv,
            save_model_weights_as_csv,
        )
        from svd_lstm_tpu.models.conv import ConvLSTMParams

        d = str(tmp_path / "export")
        save_model_weights_as_csv(hybrid, d)
        back = load_model_from_csv(d)
        assert isinstance(back, ConvLSTMParams)
        for a, b in zip(
            jax.tree_util.tree_leaves(hybrid), jax.tree_util.tree_leaves(back)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_native_dense_hybrid_parity(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.csv_weights import save_model_weights_as_csv
        from svd_lstm_tpu.io.native import NativeModel

        d = str(tmp_path / "export")
        save_model_weights_as_csv(hybrid, d)
        m = NativeModel.from_export_dir(d)
        frames = self._frames()
        assert m.input_dim == 1
        got = m.run(frames)
        ref = np.asarray(conv_lstm_apply(hybrid, jnp.asarray(frames[None])))[0, :, 0]
        np.testing.assert_allclose(got, ref, atol=2e-4)
        # reset must clear the conv shift buffer too
        m.reset()
        np.testing.assert_allclose(m.run(frames), got, atol=0)

    def test_native_reduced_hybrid_parity(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.native import NativeModel, save_reduced_weights_as_csv

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=3)
        d = str(tmp_path / "export_red")
        save_reduced_weights_as_csv(cr, d)
        m = NativeModel.from_export_dir(d)
        frames = self._frames()
        got = m.run(frames)
        ref = np.asarray(conv_reduced_apply(cr, jnp.asarray(frames[None])))[0, :, 0]
        np.testing.assert_allclose(got, ref, atol=2e-4)

    def test_native_int8_hybrid_parity(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
        from svd_lstm_tpu.io.native import NativeModel

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=3)
        frames = self._frames()
        for model, apply_fn in ((hybrid, conv_lstm_apply), (cr, conv_reduced_apply)):
            p = str(tmp_path / "model.i8bin")
            save_model_int8_bin(model, p)
            m = NativeModel.from_int8(p)
            got = m.run(frames)
            oracle = dequantized_params(model)
            oracle = jax.tree.map(jnp.asarray, oracle)
            ref = np.asarray(apply_fn(oracle, jnp.asarray(frames[None])))[0, :, 0]
            np.testing.assert_allclose(got, ref, atol=2e-4)

    def test_native_merged_hybrid_parity(self, hybrid, tmp_path):
        """Merged-kernel conv-reduced hybrid through the native runtime
        (conv front end + 'm'-kind layers), CSV and int8-v3."""
        from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
        from svd_lstm_tpu.io.native import NativeModel, save_reduced_weights_as_csv

        cs = make_conv_singular_model(hybrid, merged_kernel=True)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=12)
        frames = self._frames()
        d = str(tmp_path / "export_merged")
        save_reduced_weights_as_csv(cr, d)
        got = NativeModel.from_export_dir(d).run(frames)
        ref = np.asarray(conv_reduced_apply(cr, jnp.asarray(frames[None])))[0, :, 0]
        np.testing.assert_allclose(got, ref, atol=2e-4)

        p = str(tmp_path / "merged.i8bin")
        save_model_int8_bin(cr, p)
        got8 = NativeModel.from_int8(p).run(frames)
        oracle = jax.tree.map(jnp.asarray, dequantized_params(cr))
        ref8 = np.asarray(conv_reduced_apply(oracle, jnp.asarray(frames[None])))[0, :, 0]
        np.testing.assert_allclose(got8, ref8, atol=2e-4)

    def test_int8_v3_truncated_conv_section_refuses_load(self, hybrid, tmp_path):
        """A v3 artifact truncated inside the conv section must fail the
        native load, never hand back a handle over partial weights."""
        from svd_lstm_tpu.io.int8_export import save_model_int8_bin
        from svd_lstm_tpu.io.native import NativeModel

        p = tmp_path / "hybrid.i8bin"
        save_model_int8_bin(hybrid, str(p))
        blob = p.read_bytes()
        # magic(8) + version(4) + n_layers(4) + has_conv(1) + k,c_in(8) = 25:
        # cut mid-way through the conv qmat
        trunc = tmp_path / "trunc.i8bin"
        trunc.write_bytes(blob[:40])
        with pytest.raises(RuntimeError):
            NativeModel.from_int8(str(trunc))

    def test_conv_csv_loader_validates_shape(self, hybrid, tmp_path):
        """load_conv_front_csv cross-checks w.csv rows against shape.csv."""
        import os

        from svd_lstm_tpu.io.csv_weights import (
            load_conv_front_csv,
            save_model_weights_as_csv,
        )

        d = str(tmp_path / "export")
        save_model_weights_as_csv(hybrid, d)
        np.savetxt(
            os.path.join(d, "conv", "shape.csv"), np.array([[3, 2]]), delimiter=","
        )
        with pytest.raises(ValueError, match="shape.csv"):
            load_conv_front_csv(d)

    def test_conv_filter_mismatch_refuses_load(self, hybrid, tmp_path):
        from svd_lstm_tpu.io.csv_weights import save_model_weights_as_csv
        from svd_lstm_tpu.io.native import NativeModel

        d = str(tmp_path / "export_bad")
        save_model_weights_as_csv(hybrid, d)
        # corrupt: drop a filter column from the conv kernel
        import os

        w = np.loadtxt(os.path.join(d, "conv", "w.csv"), delimiter=",", ndmin=2)
        np.savetxt(os.path.join(d, "conv", "w.csv"), w[:, :-1], delimiter=",")
        with pytest.raises(RuntimeError):
            NativeModel.from_export_dir(d)


class TestHybridQuantize:
    def test_quantize_roundtrip_and_apply(self, hybrid, x):
        from svd_lstm_tpu.utils.quantize import (
            QuantizedTensor,
            dequantize_params,
            quantize_params,
            quantized_apply,
        )

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=3)
        for params, apply_fn in ((hybrid, conv_lstm_apply), (cr, conv_reduced_apply)):
            q = quantize_params(params)
            assert isinstance(q.conv.w, QuantizedTensor)
            assert q.conv.w.q.shape == np.asarray(params.conv.w).shape
            dq = dequantize_params(q)
            # quantization error bounded by scale/2 per element
            err = np.abs(np.asarray(dq.conv.w) - np.asarray(params.conv.w))
            assert err.max() <= float(np.max(np.asarray(q.conv.w.scale))) / 2 + 1e-7
            y_q = np.asarray(quantized_apply(apply_fn)(q, x))
            y_dq = np.asarray(apply_fn(dq, x))
            np.testing.assert_allclose(y_q, y_dq, atol=1e-6)

    def test_fake_quantize_matches_encoding(self, hybrid):
        from svd_lstm_tpu.utils.quantize import (
            dequantize_params,
            fake_quantize_params,
            quantize_params,
        )

        fq = fake_quantize_params(hybrid)
        dq = dequantize_params(quantize_params(hybrid))
        np.testing.assert_allclose(
            np.asarray(fq.conv.w), np.asarray(dq.conv.w), atol=1e-6
        )

    def test_qat_gradients_flow_to_conv(self, hybrid, x):
        from svd_lstm_tpu.utils.quantize import qat_apply

        def loss(p):
            return jnp.sum(qat_apply(conv_lstm_apply)(p, x) ** 2)

        g = jax.grad(loss)(hybrid)
        assert float(jnp.abs(g.conv.w).max()) > 0  # STE passes through


class TestHybridTooling:
    """The CLI/tooling surfaces the review flagged: input-dim derivation,
    autotune cache keys, and remat routing must all accept the hybrids."""

    def test_model_input_dim(self, hybrid):
        from svd_lstm_tpu.api import model_input_dim
        from svd_lstm_tpu.models.lstm import init_stacked_lstm

        assert model_input_dim(hybrid) == 1  # c_in, NOT filters
        cs = make_conv_singular_model(hybrid)
        assert model_input_dim(cs) == 1
        assert model_input_dim(make_conv_reduced_model(cs, rank=3)) == 1
        dense = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=6, units=(4,))
        assert model_input_dim(dense) == 6

    def test_autotune_key_and_tuned_predict(self, hybrid, x):
        from svd_lstm_tpu.bench.autotune import cache_key, predict_tuned

        cs = make_conv_singular_model(hybrid)
        cr = make_conv_reduced_model(cs, cutoff=None, rank=3)
        keys = {cache_key(p, x[0], "exact") for p in (hybrid, cs, cr)}
        assert len(keys) == 3  # families key distinctly
        ref = np.asarray(conv_reduced_apply(cr, x))
        got = np.asarray(predict_tuned(cr, x))
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_remat_chunk_reaches_hybrid_applies(self, hybrid, x):
        """resolve_train_apply_fn routes remat_chunk into the conv applies
        (identical values, no silent no-remat warning)."""
        import warnings

        from svd_lstm_tpu.train.loop import resolve_train_apply_fn

        cs = make_conv_singular_model(hybrid)
        for apply_fn, params in (
            (conv_lstm_apply, hybrid),
            (conv_singular_apply, cs),
        ):
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # the no-remat warning fails
                fn, using_kernel = resolve_train_apply_fn(
                    TrainConfig(remat_chunk=6), apply_fn
                )
            assert not using_kernel
            np.testing.assert_allclose(
                np.asarray(fn(params, x)),
                np.asarray(apply_fn(params, x)),
                atol=1e-6,
            )


class TestHybridRankSweep:
    def test_sweep_runs_on_hybrid(self, hybrid):
        """The H3 rank sweep works over the hybrid's LSTM stack (the conv
        kernel is not a gate block, so it never enters the σ ordering)."""
        from svd_lstm_tpu.config import SweepConfig
        from svd_lstm_tpu.bench.sweep import rank_sweep

        rng = np.random.default_rng(5)
        X = rng.normal(size=(1, 40, 1)).astype(np.float32)
        y = rng.normal(size=(40,)).astype(np.float32)
        ident = type("I", (), {"inverse_transform": staticmethod(lambda a: a)})()
        res = rank_sweep(
            hybrid, X, y, ident.inverse_transform,
            cfg=SweepConfig(evaluate_every=4), max_reductions=12,
        )
        assert res.rmse_ratio[0] == pytest.approx(1.0)
        assert res.reductions_done > 0
        assert (np.diff(res.weights_eliminated) >= 0).all()


class TestHybridPruning:
    def test_prune_and_sparsity(self, hybrid):
        from svd_lstm_tpu.factor.prune_magnitude import prune_sigmas, sigma_sparsity

        cs = make_conv_singular_model(hybrid)
        pruned = prune_sigmas(cs, 0.5)
        assert type(pruned) is type(cs)
        assert sigma_sparsity(pruned) == pytest.approx(0.5, abs=0.05)
        np.testing.assert_array_equal(
            np.asarray(pruned.conv.w), np.asarray(cs.conv.w)
        )

    def test_pruning_finetune_runs(self, hybrid, rng_module):
        from svd_lstm_tpu.factor.prune_magnitude import (
            PolynomialDecaySchedule,
            finetune_with_pruning,
            sigma_sparsity,
        )

        X = rng_module.normal(size=(1, 120, 1)).astype(np.float32)
        y = (0.1 * np.cumsum(X[0, :, 0])).astype(np.float32)
        cs = make_conv_singular_model(hybrid)
        res = finetune_with_pruning(
            cs, X, y,
            schedule=PolynomialDecaySchedule(
                final_sparsity=0.5, begin_step=0, end_step=4
            ),
            train_cfg=TrainConfig(**_FT_KW),
            factor_cfg=FactorConfig(hoyer=0.0),
        )
        assert sigma_sparsity(res.params) == pytest.approx(0.5, abs=0.05)
        assert np.isfinite(np.asarray(res.history)).all()


def test_conv_compression_example_smoke(tmp_path):
    """examples/conv_compression.py drives the whole hybrid workflow
    (train → factorize → fine-tune → truncate → native consumer) with
    parity asserts inside the script. --out points at tmp so the test
    never writes build outputs into the repo tree."""
    import os
    import subprocess
    import sys

    from conftest import REPO_DIR, subprocess_env

    env = subprocess_env(JAX_PLATFORMS="cpu")
    script = os.path.join(REPO_DIR, "examples", "conv_compression.py")
    out = subprocess.run(
        [sys.executable, script, "--quick", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "conv compression workflow OK" in out.stdout, out.stdout[-2000:]


_FT_KW = dict(num_windows=8, window_len=12, batch_size=4, epochs=2, seed=0)


class TestHybridFinetune:
    def _data(self, rng, T=120):
        X = rng.normal(size=(1, T, 1)).astype(np.float32)
        y = (0.1 * np.cumsum(X[0, :, 0])).astype(np.float32)
        return X, y

    def test_sigma_only_freezes_conv(self, hybrid, rng_module):
        """σ-only fine-tune: conv front end + factors frozen, σ + head move."""
        X, y = self._data(rng_module)
        cs = make_conv_singular_model(hybrid)
        res = finetune(
            cs,
            X,
            y,
            factor_cfg=FactorConfig(hoyer=1e-4, train_uv=False),
            train_cfg=TrainConfig(**_FT_KW),
        )
        out = res.params
        np.testing.assert_array_equal(np.asarray(out.conv.w), np.asarray(cs.conv.w))
        np.testing.assert_array_equal(
            np.asarray(out.inner.layers[0].wl), np.asarray(cs.inner.layers[0].wl)
        )
        assert not np.allclose(
            np.asarray(out.inner.layers[0].ws), np.asarray(cs.inner.layers[0].ws)
        )
        assert np.isfinite(np.asarray(res.history)).all()

    def test_train_uv_updates_conv(self, hybrid, rng_module):
        X, y = self._data(rng_module)
        cs = make_conv_singular_model(hybrid)
        res = finetune(
            cs,
            X,
            y,
            factor_cfg=FactorConfig(hoyer=1e-4, train_uv=True),
            train_cfg=TrainConfig(**_FT_KW),
        )
        assert not np.allclose(np.asarray(res.params.conv.w), np.asarray(cs.conv.w))

    def test_harvest_sigmas_hybrid(self, hybrid):
        cs = make_conv_singular_model(hybrid)
        sig = harvest_sigmas(cs)
        assert len(sig) == len(cs.inner.layers)
        assert sig[0][0].shape == (4, 8)

    def test_finetune_with_dropout(self, hybrid, rng_module):
        """Dropout routing reaches conv_singular_apply through the wrapper."""
        X, y = self._data(rng_module)
        cs = make_conv_singular_model(hybrid)
        res = finetune(
            cs,
            X,
            y,
            factor_cfg=FactorConfig(hoyer=1e-4, dropout=0.2, recurrent_dropout=0.1),
            train_cfg=TrainConfig(**{**_FT_KW, "epochs": 1}),
        )
        assert np.isfinite(np.asarray(res.history)).all()
