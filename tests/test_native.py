"""Native C++ streaming runtime vs the JAX reference (exactness oracle for
the CSV export path)."""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io.csv_weights import save_model_weights_as_csv
from svd_lstm_tpu.io.native import NativeModel, build_native, save_reduced_weights_as_csv
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("make") is None,
    reason="no native toolchain",
)


@pytest.fixture(scope="module")
def dense():
    return init_stacked_lstm(jax.random.PRNGKey(7), input_dim=6, units=(10, 8))


def test_build():
    assert build_native()


def test_dense_native_matches_jax(tmp_path, dense, rng):
    save_model_weights_as_csv(dense, str(tmp_path))
    nm = NativeModel(str(tmp_path), ["lstm_0", "lstm_1"], "dd", transposed=False)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y_native = nm.run(x)
    y_jax = np.asarray(stacked_lstm_apply(dense, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_jax, atol=1e-4)


def test_reduced_native_matches_jax(tmp_path, dense, rng):
    rmodel = make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=4)
    save_reduced_weights_as_csv(rmodel, str(tmp_path))
    nm = NativeModel(str(tmp_path), ["lstm_0", "lstm_1"], "rr")
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y_native = nm.run(x)
    y_jax = np.asarray(reduced_lstm_apply(rmodel, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_jax, atol=1e-4)


def test_reset_and_statefulness(tmp_path, dense, rng):
    save_model_weights_as_csv(dense, str(tmp_path))
    nm = NativeModel(str(tmp_path), ["lstm_0", "lstm_1"], "dd")
    x = rng.normal(size=(10, 6)).astype(np.float32)
    a = nm.run(x)
    b = nm.run(x)          # state carried -> different output
    assert not np.allclose(a, b)
    nm.reset()
    c = nm.run(x)          # reset -> reproduces the first run
    np.testing.assert_allclose(a, c, atol=1e-6)


def test_loads_reference_fixtures(reference_dir, rng):
    """The native runtime consumes the reference's shipped (transposed)
    LabVIEW export directly."""
    import os

    path = os.path.join(reference_dir, "code", "model_weights")
    # reference dense_top files are named weights/bias; layer dirs lstm_69..71
    nm = NativeModel(path, ["lstm_69", "lstm_70", "lstm_71"], "ddd", transposed=True)
    x = rng.normal(size=(30, 16)).astype(np.float32)
    y = nm.run(x)
    assert np.isfinite(y).all()

    from svd_lstm_tpu.io.csv_weights import load_model_from_csv

    params = load_model_from_csv(path, ["lstm_69", "lstm_70", "lstm_71"], transposed=True)
    y_jax = np.asarray(stacked_lstm_apply(params, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y, y_jax, atol=1e-4)


def test_int8_artifact_dense_matches_dequantized_oracle(tmp_path, rng):
    """int8 binary round-trip: the native runtime must reproduce the
    dequantized-weights JAX forward (identical q*scale arithmetic on both
    sides), NOT the original f32 model — quantization error belongs to the
    artifact, not the runtime."""
    import jax.numpy as jnp

    from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
    from svd_lstm_tpu.io.native import NativeModel

    params = init_stacked_lstm(jax.random.PRNGKey(11), input_dim=6, units=(10, 8))
    path = str(tmp_path / "model_int8.bin")
    nbytes = save_model_int8_bin(params, path)
    # ~4x smaller than the f32 weights it encodes
    f32_bytes = sum(np.asarray(l).size * 4 for layer in params.layers for l in layer)
    assert nbytes < 0.45 * f32_bytes + 2048

    nm = NativeModel.from_int8(path)
    x = rng.normal(size=(25, 6)).astype(np.float32)
    y_native = nm.run(x)

    dq = dequantized_params(params)
    y_oracle = np.asarray(stacked_lstm_apply(dq, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_oracle, atol=1e-4)
    # sanity: still close to the unquantized model (int8 roundoff only)
    y_f32 = np.asarray(stacked_lstm_apply(params, jnp.asarray(x)[None]))[0, :, 0]
    assert np.abs(y_native - y_f32).max() < 0.05


def test_int8_artifact_reduced_matches_dequantized_oracle(tmp_path, rng):
    import jax.numpy as jnp

    from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
    from svd_lstm_tpu.io.native import NativeModel
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply

    dense = init_stacked_lstm(jax.random.PRNGKey(12), input_dim=6, units=(8, 8))
    red = make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=5)
    path = str(tmp_path / "reduced_int8.bin")
    save_model_int8_bin(red, path)

    nm = NativeModel.from_int8(path)
    x = rng.normal(size=(20, 6)).astype(np.float32)
    y_native = nm.run(x)

    dq = dequantized_params(red)
    y_oracle = np.asarray(reduced_lstm_apply(dq, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_oracle, atol=1e-4)


def test_mixed_kinds_native_matches_jax(tmp_path, rng):
    """The published deployment shape: dense outer layers, reduced middle
    (cells 2-3 reduced, slide 13) — per-layer kind string 'drrd'."""
    import os

    import jax.numpy as jnp

    from svd_lstm_tpu.models.lstm import LSTMLayerParams, StackedLSTMParams

    dense4 = init_stacked_lstm(jax.random.PRNGKey(9), input_dim=6, units=(8, 8, 8, 8))
    red4 = make_reduced_model(make_singular_model(dense4, merged_kernel=False), rank=4)

    save_model_weights_as_csv(dense4, os.path.join(tmp_path, "dense"))
    from svd_lstm_tpu.io.native import save_reduced_weights_as_csv as save_red

    save_red(red4, os.path.join(tmp_path, "red"))
    os.rename(os.path.join(tmp_path, "dense", "dense_top"),
              os.path.join(tmp_path, "dense_top"))

    nm = NativeModel(
        str(tmp_path),
        ["dense/lstm_0", "red/lstm_1", "red/lstm_2", "dense/lstm_3"],
        "drrd",
    )
    x = rng.normal(size=(30, 6)).astype(np.float32)
    y_native = nm.run(x)

    # JAX oracle: dense layers 0,3 + exactly-reconstructed reduced 1,2
    from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

    red_dense = reconstruct_dense_model(red4)
    mixed = StackedLSTMParams(
        layers=(
            dense4.layers[0],
            red_dense.layers[1],
            red_dense.layers[2],
            dense4.layers[3],
        ),
        head=dense4.head,
    )
    y_jax = np.asarray(stacked_lstm_apply(mixed, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_jax, atol=1e-4)


def test_load_time_dispatch_densifies_shallow_ranks(tmp_path, dense, rng):
    """'r' kind: a reduced export whose rank can't pay for the two-step
    (r/n >= 0.45) is reconstructed to dense at load; 'R' forces the raw
    factored path. Both give identical numerics."""
    # rank 8 of n=10/8: r/n = 0.8 and 1.0 -> both sides densify
    rmodel = make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=8)
    save_reduced_weights_as_csv(rmodel, str(tmp_path))
    auto = NativeModel(str(tmp_path), ["lstm_0", "lstm_1"], "rr")
    forced = NativeModel(str(tmp_path), ["lstm_0", "lstm_1"], "RR")
    for li in range(2):
        ai = auto.layer_info(li)
        fi = forced.layer_info(li)
        assert not ai["w_reduced"] and not ai["u_reduced"], ai
        assert fi["w_reduced"] and fi["u_reduced"], fi
    x = rng.normal(size=(40, 6)).astype(np.float32)
    np.testing.assert_allclose(auto.run(x), forced.run(x), atol=1e-4)
    # deep rank keeps the factored path under 'r'
    rdeep = make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=3)
    d2 = tmp_path / "deep"
    save_reduced_weights_as_csv(rdeep, str(d2))
    deep = NativeModel(str(d2), ["lstm_0", "lstm_1"], "rr")
    info = deep.layer_info(0)
    assert info["w_reduced"] and info["u_reduced"], info
    y_native = deep.run(x)
    y_jax = np.asarray(reduced_lstm_apply(rdeep, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_jax, atol=1e-4)


def test_int8_artifact_dispatch_and_force(tmp_path, rng):
    """The int8 loader applies the same load-time execution dispatch as
    the CSV path (shallow ranks densify; force_two_step keeps the factored
    path) with identical numerics."""
    from svd_lstm_tpu.io.int8_export import save_model_int8_bin
    from svd_lstm_tpu.io.native import NativeModel

    dense2 = init_stacked_lstm(jax.random.PRNGKey(13), input_dim=6, units=(10, 8))
    # rank 7 of n=10/8: r/n >= 0.7 -> both sides densify under dispatch
    red = make_reduced_model(make_singular_model(dense2, merged_kernel=False), rank=7)
    path = str(tmp_path / "r7_int8.bin")
    save_model_int8_bin(red, path)

    auto = NativeModel.from_int8(path)
    forced = NativeModel.from_int8(path, force_two_step=True)
    ai, fi = auto.layer_info(0), forced.layer_info(0)
    assert not ai["w_reduced"] and not ai["u_reduced"], ai
    assert fi["w_reduced"] and fi["u_reduced"], fi
    x = rng.normal(size=(20, 6)).astype(np.float32)
    np.testing.assert_allclose(auto.run(x), forced.run(x), atol=1e-4)


def test_native_rejects_corrupt_and_mismatched_inputs(tmp_path, dense, rng):
    """Loader hardening: ragged CSV rows, dirs/kinds count mismatches and
    a multi-output head must all FAIL the load — each previously produced
    a silently wrong (or OOB-reading) model."""
    from svd_lstm_tpu.models.lstm import DenseParams

    base = tmp_path / "ok"
    save_model_weights_as_csv(dense, str(base))
    # baseline loads
    NativeModel(str(base), ["lstm_0", "lstm_1"], "dd", transposed=False)

    # (a) dirs/kinds count mismatch: 2 dirs, 3 kinds — must refuse, not
    # build a truncated model
    with pytest.raises(RuntimeError):
        NativeModel(str(base), ["lstm_0", "lstm_1"], "ddd", transposed=False)
    with pytest.raises(RuntimeError):
        NativeModel(str(base), ["lstm_0"], "dd", transposed=False)

    # (b) ragged CSV: truncate one row of a gate matrix
    import shutil as _sh

    ragged = tmp_path / "ragged"
    _sh.copytree(base, ragged)
    wi = ragged / "lstm_0" / "Wi.csv"
    lines = wi.read_text().strip().splitlines()
    lines[1] = ",".join(lines[1].split(",")[:-2])  # drop 2 values from row 1
    wi.write_text("\n".join(lines) + "\n")
    with pytest.raises(RuntimeError):
        NativeModel(str(ragged), ["lstm_0", "lstm_1"], "dd", transposed=False)

    # (c) multi-output head: head dot would read past the last layer's h
    wide_head = tmp_path / "widehead"
    _sh.copytree(base, wide_head)
    np.savetxt(
        wide_head / "dense_top" / "weights.csv",
        rng.normal(size=(8, 2)).astype(np.float32),
        delimiter=",",
    )
    with pytest.raises(RuntimeError):
        NativeModel(str(wide_head), ["lstm_0", "lstm_1"], "dd", transposed=False)


def test_int8_loader_rejects_truncated_and_corrupt_artifacts(tmp_path):
    """A truncated or wrong-magic int8 artifact must fail the load, never
    return a handle over partial weights."""
    from svd_lstm_tpu.io.int8_export import save_model_int8_bin

    params = init_stacked_lstm(jax.random.PRNGKey(12), input_dim=6, units=(10, 8))
    path = tmp_path / "model_int8.bin"
    save_model_int8_bin(params, str(path))
    blob = path.read_bytes()

    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(RuntimeError):
        NativeModel.from_int8(str(trunc))

    bad = tmp_path / "badmagic.bin"
    bad.write_bytes(b"NOTMAGIC" + blob[8:])
    with pytest.raises(RuntimeError):
        NativeModel.from_int8(str(bad))


def test_from_export_dir_discovers_layers_and_kinds(tmp_path, dense, rng):
    """One-call consumer load: from_export_dir reads the layer list and
    per-layer kind (dense vs two-step reduced) from the files present."""
    x = rng.normal(size=(30, 6)).astype(np.float32)

    d_dense = tmp_path / "dense"
    save_model_weights_as_csv(dense, str(d_dense))
    nm = NativeModel.from_export_dir(str(d_dense))
    y_jax = np.asarray(stacked_lstm_apply(dense, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(nm.run(x), y_jax, atol=1e-4)

    reduced = make_reduced_model(
        make_singular_model(dense, merged_kernel=False), rank=6
    )
    d_red = tmp_path / "reduced"
    save_reduced_weights_as_csv(reduced, str(d_red))
    nm_r = NativeModel.from_export_dir(str(d_red))
    y_red = np.asarray(reduced_lstm_apply(reduced, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(nm_r.run(x), y_red, atol=1e-4)
    # force_two_step still loads (the 'R' kind)
    nm_f = NativeModel.from_export_dir(str(d_red), force_two_step=True)
    np.testing.assert_allclose(nm_f.run(x), y_red, atol=1e-4)

    with pytest.raises(RuntimeError):
        NativeModel.from_export_dir(str(tmp_path / "nowhere_such"))


def test_input_dim_and_frame_width_guard(tmp_path, dense, rng):
    """A frame narrower/wider than the model's input width must be refused
    (previously an out-of-bounds read inside layer_step): Python raises an
    actionable ValueError; the raw C entry point returns a quiet NaN."""
    import ctypes

    save_model_weights_as_csv(dense, str(tmp_path))
    nm = NativeModel.from_export_dir(str(tmp_path))
    assert nm.input_dim == 6

    with pytest.raises(ValueError, match="expects 6"):
        nm.step(np.ones(1, np.float32))
    with pytest.raises(ValueError, match="expects 6"):
        nm.step(np.ones(7, np.float32))
    with pytest.raises(ValueError, match="expects 6"):
        nm.run(rng.normal(size=(5, 3)).astype(np.float32))

    # raw C ABI: mismatched d -> NaN, never a read past the buffer
    short = np.ones(2, np.float32)
    ptr = short.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert np.isnan(nm._lib.svdlstm_step(nm._h, ptr, short.size))
    # a correct frame still steps fine afterwards
    nm.reset()
    assert np.isfinite(nm.step(np.ones(6, np.float32)))


def test_merged_reduced_native_matches_jax_csv(tmp_path, dense, rng):
    """Merged-kernel reduced models stream natively from the CSV export
    (kind 'm' — round 3; the reference's merged cell is
    svd_classes_v3.py:249-279). force_two_step=True pins the raw factored
    path; the default dispatch may densify but must stay exact."""
    rmodel = make_reduced_model(make_singular_model(dense, merged_kernel=True), rank=6)
    save_reduced_weights_as_csv(rmodel, str(tmp_path))
    x = rng.normal(size=(30, 6)).astype(np.float32)
    y_jax = np.asarray(reduced_lstm_apply(rmodel, jnp.asarray(x)[None]))[0, :, 0]
    for force in (False, True):
        nm = NativeModel.from_export_dir(str(tmp_path), force_two_step=force)
        np.testing.assert_allclose(nm.run(x), y_jax, atol=1e-4)
    forced = NativeModel.from_export_dir(str(tmp_path), force_two_step=True)
    assert forced.layer_info(0)["w_reduced"] and forced.layer_info(0)["u_reduced"]


def test_merged_reduced_int8_matches_dequantized_oracle(tmp_path, rng):
    """int8 format v2 kind 'm': the native consumer reproduces the
    dequantized oracle for merged reduced models (compensated C encoding
    on both sides of the comparison)."""
    from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin

    dense2 = init_stacked_lstm(jax.random.PRNGKey(13), input_dim=6, units=(8, 8))
    red = make_reduced_model(make_singular_model(dense2, merged_kernel=True), rank=5)
    path = str(tmp_path / "merged_int8.bin")
    save_model_int8_bin(red, path)

    nm = NativeModel.from_int8(path)
    x = rng.normal(size=(20, 6)).astype(np.float32)
    y_native = nm.run(x)

    dq = dequantized_params(red)
    y_oracle = np.asarray(reduced_lstm_apply(dq, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(y_native, y_oracle, atol=1e-4)


def test_mixed_split_merged_export_dir(tmp_path, rng):
    """A model whose layers mix split and merged reduced forms exports and
    loads layer-by-layer (kinds discovered per directory)."""
    import os

    from svd_lstm_tpu.models.reduced import ReducedModelParams

    dense2 = init_stacked_lstm(jax.random.PRNGKey(14), input_dim=6, units=(8, 8))
    red_s = make_reduced_model(make_singular_model(dense2, merged_kernel=False), rank=5)
    red_m = make_reduced_model(make_singular_model(dense2, merged_kernel=True), rank=5)
    mixed = ReducedModelParams(
        layers=(red_s.layers[0], red_m.layers[1]), head=red_s.head
    )
    save_reduced_weights_as_csv(mixed, str(tmp_path))
    assert os.path.exists(tmp_path / "lstm_0" / "wBi.csv")
    assert os.path.exists(tmp_path / "lstm_1" / "wB.csv")
    nm = NativeModel.from_export_dir(str(tmp_path))
    x = rng.normal(size=(25, 6)).astype(np.float32)
    y_jax = np.asarray(reduced_lstm_apply(mixed, jnp.asarray(x)[None]))[0, :, 0]
    np.testing.assert_allclose(nm.run(x), y_jax, atol=1e-4)
