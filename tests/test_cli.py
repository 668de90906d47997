"""CLI surface: the `export` subcommand (checkpoint -> deployment artifacts,
the reference's LabVIEW export role, code/load_preprocess.py:80-165)."""

import os

import numpy as np
import jax

from svd_lstm_tpu.__main__ import _export
from svd_lstm_tpu.io.checkpoint import load_params, save_params
from svd_lstm_tpu.io.csv_weights import load_model_from_csv
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.utils.quantize import QuantizedTensor


def test_export_command_roundtrip(tmp_path):
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
    ckpt = str(tmp_path / "model.npz")
    save_params(ckpt, params)
    outdir = str(tmp_path / "deploy")

    _export([ckpt, outdir, "--json", "--int8"])

    # per-gate CSVs reassemble into the same model
    loaded = load_model_from_csv(outdir, transposed=False)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)

    assert os.path.exists(os.path.join(outdir, "model_weights.json"))

    q = load_params(os.path.join(outdir, "model_int8.npz"))
    assert isinstance(q.layers[0].W, QuantizedTensor)


def test_tune_command_prints_table_and_caches(tmp_path, capsys, monkeypatch):
    """CLI tune: measures valid impls for a checkpoint, prints the table
    with a winner, memoizes to the autotune cache. Device time needs the
    GPU, so the CPU run injects a host-clock timer."""
    import time

    import svd_lstm_tpu.bench.autotune as at
    from svd_lstm_tpu.__main__ import _tune

    def wall_timer(fn, *args, repeats=1):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) * 1e3 + 1e-6

    monkeypatch.setattr(at, "device_time_ms", wall_timer)

    params = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=4, units=(6,))
    ckpt = str(tmp_path / "m.npz")
    save_params(ckpt, params)
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "default_cache_path", lambda: cache)
    _tune(["--checkpoint", ckpt, "--steps", "16", "--repeats", "1"])
    out = capsys.readouterr().out
    assert "winner" in out and "scan" in out
    assert os.path.exists(cache)


def test_stream_command_jax_and_native_parity(tmp_path, capsys):
    """CLI stream: frame CSV in -> one prediction line per frame out,
    matching the whole-run scan; the reduced CSV export dir auto-routes to
    the native runtime and agrees with the JAX reduced apply."""
    import shutil

    import jax.numpy as jnp

    from svd_lstm_tpu.__main__ import _stream
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply

    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=4, units=(6, 5))
    ckpt = str(tmp_path / "dense.npz")
    save_params(ckpt, params)
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(12, 4)).astype(np.float32)
    fin = str(tmp_path / "frames.csv")
    np.savetxt(fin, frames, delimiter=",")
    fout = str(tmp_path / "pred.csv")

    _stream([ckpt, "--input", fin, "--output", fout])
    got = np.loadtxt(fout, delimiter=",")
    want = np.asarray(
        stacked_lstm_apply(params, jnp.asarray(frames)[None])
    )[0, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-5)

    if shutil.which("g++") or shutil.which("make"):
        from svd_lstm_tpu.io.native import save_reduced_weights_as_csv

        reduced = make_reduced_model(
            make_singular_model(params, merged_kernel=False), rank=4
        )
        d_red = str(tmp_path / "reduced_csv")
        save_reduced_weights_as_csv(reduced, d_red)
        fout2 = str(tmp_path / "pred_red.csv")
        _stream([d_red, "--input", fin, "--output", fout2])
        got_r = np.loadtxt(fout2, delimiter=",")
        want_r = np.asarray(
            reduced_lstm_apply(reduced, jnp.asarray(frames)[None])
        )[0, :, 0]
        np.testing.assert_allclose(got_r, want_r, atol=1e-4)


def test_stream_command_rejects_bad_frames_and_runs_merged_native(tmp_path):
    """Stream hardening: a mis-sized frame line exits with an actionable
    message (both engines validate width up front). A merged-kernel
    reduced checkpoint under --native streams through the runtime's 'm'
    layer kind (round 3; previously refused)."""
    import shutil

    import pytest

    from svd_lstm_tpu.__main__ import _stream
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply

    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=4, units=(6, 5))
    ckpt = str(tmp_path / "dense.npz")
    save_params(ckpt, params)

    fin = str(tmp_path / "short.csv")
    with open(fin, "w") as f:
        f.write("1.0,2.0\n")  # model expects 4 values per frame
    with pytest.raises(SystemExit, match="expects 4"):
        _stream([ckpt, "--input", fin, "--output", str(tmp_path / "o.csv")])

    if not (shutil.which("g++") or shutil.which("make")):
        pytest.skip("no native toolchain")
    import jax.numpy as jnp

    merged = make_reduced_model(
        make_singular_model(params, merged_kernel=True), rank=4
    )
    mck = str(tmp_path / "merged_reduced.npz")
    save_params(mck, merged)
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(8, 4)).astype(np.float32)
    fin2 = str(tmp_path / "frames.csv")
    np.savetxt(fin2, frames, delimiter=",")
    fout = str(tmp_path / "o2.csv")
    _stream([mck, "--native", "--input", fin2, "--output", fout])
    got = np.loadtxt(fout, delimiter=",")
    want = np.asarray(reduced_lstm_apply(merged, jnp.asarray(frames)[None]))[0, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stream_command_int8_bin_artifact(tmp_path):
    """Stream auto-routes a .bin artifact to the native engine and matches
    the dequantized-oracle prediction within int8 quantization error."""
    import shutil

    import pytest

    if not (shutil.which("g++") or shutil.which("make")):
        pytest.skip("no native toolchain")

    import jax.numpy as jnp

    from svd_lstm_tpu.__main__ import _stream
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply

    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=4, units=(6, 5))
    reduced = make_reduced_model(
        make_singular_model(params, merged_kernel=False), rank=4
    )
    art = str(tmp_path / "model.bin")
    save_model_int8_bin(reduced, art)

    rng = np.random.default_rng(1)
    frames = rng.normal(size=(10, 4)).astype(np.float32)
    fin = str(tmp_path / "frames.csv")
    np.savetxt(fin, frames, delimiter=",")
    fout = str(tmp_path / "pred.csv")
    _stream([art, "--input", fin, "--output", fout])

    got = np.loadtxt(fout, delimiter=",")
    want = np.asarray(
        reduced_lstm_apply(dequantized_params(reduced), jnp.asarray(frames)[None])
    )[0, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stream_command_conv_hybrid_checkpoint(tmp_path):
    """CLI stream over a conv-hybrid checkpoint: the JAX path derives the
    frame width from the conv front end (c_in, not filters — round-3
    review fix), and the native path consumes the conv-reduced export."""
    import jax.numpy as jnp

    from svd_lstm_tpu.__main__ import _stream
    from svd_lstm_tpu.factor.svd import (
        make_conv_reduced_model,
        make_conv_singular_model,
    )
    from svd_lstm_tpu.models.conv import (
        conv_lstm_apply,
        conv_reduced_apply,
        init_conv_lstm,
    )

    hybrid = init_conv_lstm(
        jax.random.PRNGKey(4), in_channels=2, filters=6, kernel_size=4,
        units=(6, 5),
    )
    ckpt = str(tmp_path / "hybrid.npz")
    save_params(ckpt, hybrid)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(12, 2)).astype(np.float32)
    fin = str(tmp_path / "frames.csv")
    np.savetxt(fin, frames, delimiter=",")

    fout = str(tmp_path / "pred.csv")
    _stream([ckpt, "--input", fin, "--output", fout])
    got = np.loadtxt(fout, delimiter=",")
    want = np.asarray(conv_lstm_apply(hybrid, jnp.asarray(frames)[None]))[0, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-5)

    # conv-reduced checkpoint through the --native temp-export route
    cr = make_conv_reduced_model(make_conv_singular_model(hybrid), rank=3)
    ckpt_r = str(tmp_path / "hybrid_reduced.npz")
    save_params(ckpt_r, cr)
    fout_r = str(tmp_path / "pred_red.csv")
    _stream([ckpt_r, "--native", "--input", fin, "--output", fout_r])
    got_r = np.loadtxt(fout_r, delimiter=",")
    want_r = np.asarray(conv_reduced_apply(cr, jnp.asarray(frames)[None]))[0, :, 0]
    np.testing.assert_allclose(got_r, want_r, atol=2e-4)


def test_stream_command_quantized_npz_checkpoint(tmp_path):
    """An int8-quantized npz checkpoint (export --int8's model_int8.npz)
    streams as the f32 model it encodes — the CLI dequantizes on load
    instead of crashing on QuantizedTensor leaves."""
    import jax.numpy as jnp

    from svd_lstm_tpu.__main__ import _stream
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply
    from svd_lstm_tpu.utils.quantize import dequantize_params, quantize_params

    params = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=3, units=(6,))
    q = quantize_params(params)
    ckpt = str(tmp_path / "model_int8.npz")
    save_params(ckpt, q)
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(10, 3)).astype(np.float32)
    fin = str(tmp_path / "frames.csv")
    np.savetxt(fin, frames, delimiter=",")
    fout = str(tmp_path / "pred.csv")

    _stream([ckpt, "--input", fin, "--output", fout])
    got = np.loadtxt(fout, delimiter=",")
    want = np.asarray(
        stacked_lstm_apply(dequantize_params(q), jnp.asarray(frames)[None])
    )[0, :, 0]
    np.testing.assert_allclose(got, want, atol=1e-5)
