"""JSON weight export, json_to_csv, devtime on CPU."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.bench.devtime import device_time_ms
from svd_lstm_tpu.io.csv_weights import json_to_csv, save_model_weights_as_json
from svd_lstm_tpu.models.lstm import init_stacked_lstm


def test_json_export_roundtrip(tmp_path):
    params = init_stacked_lstm(jax.random.PRNGKey(0), 4, (6,))
    p = str(tmp_path / "w.json")
    save_model_weights_as_json(params, p)
    with open(p) as f:
        data = json.load(f)
    assert set(data) == {"layer0", "layer1"}
    W = np.asarray(data["layer0"][0])
    np.testing.assert_allclose(W, np.asarray(params.layers[0].W), rtol=1e-6)


def test_json_to_csv(tmp_path):
    src = str(tmp_path / "data.json")
    with open(src, "w") as f:
        json.dump({"a": [1.0, 2.0, 3.0], "b": "not a list", "c": [[1, 2], [3, 4]]}, f)
    out = str(tmp_path / "csvs")
    json_to_csv(src, out)
    assert np.loadtxt(os.path.join(out, "a.csv"), delimiter=",").shape == (3,)
    assert np.loadtxt(os.path.join(out, "c.csv"), delimiter=",").shape == (2, 2)
    assert not os.path.exists(os.path.join(out, "b.csv"))


def test_device_time_ms_cpu():
    """On the CPU the trace has no GPU device plane: device_time_ms raises
    rather than reporting host time as device time."""
    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    x = jnp.ones((256, 256))
    with pytest.raises(RuntimeError, match="no kernel events"):
        device_time_ms(f, x, repeats=1)


_GPU_TRACE = """
planes { id: 1 name: "/host:CPU" lines { id: 1 name: "python"
  events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000000 } }
  event_metadata { key: 1 value { id: 1 name: "PjitFunction(f)" } } }
planes { id: 2 name: "/device:GPU:0"
  lines { id: 3 name: "Stream #13(Compute)"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2500000 }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 500000 } }
  lines { id: 4 name: "Stream #14(MemcpyD2D)"
    events { metadata_id: 2 offset_ps: 0 duration_ps: 250000 } }
  event_metadata { key: 1 value { id: 1 name: "lstm_recurrence_fwd" } }
  event_metadata { key: 2 value { id: 2 name: "loop_add_fusion" } } }
"""


@pytest.mark.parametrize("drop_device_plane", [False, True])
def test_kernel_ms_sums_gpu_stream_events(drop_device_plane):
    """The device-time reduction on a recorded GPU-shaped trace: every
    kernel event on a /device:GPU:* stream line counts, host spans never
    do; without a device plane it raises."""
    from jax.profiler import ProfileData

    from svd_lstm_tpu.bench.devtime import kernel_events, kernel_ms

    txt = _GPU_TRACE
    if drop_device_plane:
        txt = txt[: txt.index('planes { id: 2')]
    pdata = ProfileData.from_text_proto(txt)
    if drop_device_plane:
        with pytest.raises(RuntimeError):
            kernel_ms(pdata)
        return
    assert kernel_ms(pdata) == pytest.approx(2.5e-3 + 0.5e-3 + 0.25e-3)
    names = sorted(ev.name for _, _, ev in kernel_events(pdata))
    assert names == ["loop_add_fusion", "loop_add_fusion", "lstm_recurrence_fwd"]


def test_csv_default_roundtrip_is_exact(tmp_path, rng):
    """Default save → default load round-trips exactly: the layout marker
    makes auto-detection pick the untransposed convention (round-3 review
    finding: square gate blocks silently loaded transposed)."""
    from svd_lstm_tpu.io.csv_weights import (
        load_model_from_csv,
        save_model_weights_as_csv,
    )
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    # square blocks everywhere (d == n) — the case the old default corrupted
    params = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=8, units=(8, 8))
    save_model_weights_as_csv(params, str(tmp_path))
    back = load_model_from_csv(str(tmp_path))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_csv_single_column_blocks_keep_orientation(tmp_path, rng):
    """in_dim=1 layers: (1, n) W blocks survive the round trip (ndmin=2
    keeps single-row/column orientation — round-3 review finding)."""
    from svd_lstm_tpu.io.csv_weights import (
        load_model_from_csv,
        save_model_weights_as_csv,
    )
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=1, units=(5,))
    save_model_weights_as_csv(params, str(tmp_path))
    back = load_model_from_csv(str(tmp_path))
    assert back.layers[0].W.shape == (1, 20)
    np.testing.assert_allclose(
        np.asarray(back.layers[0].W), np.asarray(params.layers[0].W), atol=1e-6
    )


def test_json_to_csv_consumes_own_json(tmp_path):
    """json_to_csv handles the ragged [W, U, b] layer entries its own
    writer produces (the reference's version raises; round-3 review)."""
    from svd_lstm_tpu.io.csv_weights import json_to_csv, save_model_weights_as_json
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(4), input_dim=4, units=(6,))
    jpath = str(tmp_path / "w.json")
    save_model_weights_as_json(params, jpath)
    out = tmp_path / "csv"
    json_to_csv(jpath, str(out))
    got = sorted(p.name for p in out.iterdir())
    assert "layer0_0.csv" in got and "layer0_2.csv" in got
    W = np.loadtxt(out / "layer0_0.csv", delimiter=",")
    np.testing.assert_allclose(W, np.asarray(params.layers[0].W), atol=1e-6)


def test_int8_export_rejects_multi_output_head():
    from svd_lstm_tpu.io.int8_export import save_model_int8_bin
    from svd_lstm_tpu.models.lstm import DenseParams, init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=4, units=(6,))
    import jax.numpy as jnp

    wide_head = DenseParams(w=jnp.zeros((6, 2)), b=jnp.zeros((2,)))
    with pytest.raises(ValueError, match="single-output head"):
        save_model_int8_bin(params._replace(head=wide_head), "/tmp/never.bin")


def test_predict_rejects_unknown_impl(rng):
    import svd_lstm_tpu as st
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(6), input_dim=4, units=(6,))
    x = jnp.asarray(rng.normal(size=(5, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown impl"):
        st.predict(params, x, impl="fuse")


def test_checkpoint_rejects_unknown_node_at_save_time(tmp_path):
    """save_params must fail for NamedTuple nodes load_params can't rebuild
    (e.g. optax states) INSTEAD of writing an unreadable checkpoint."""
    import optax

    from svd_lstm_tpu.io.checkpoint import save_params
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6,))
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "opt.npz")
    with pytest.raises(TypeError, match="cannot checkpoint node type"):
        save_params(path, opt_state)
    assert not os.path.exists(path)  # nothing half-written


def test_csv_layer_dirs_sort_numerically(tmp_path, rng):
    """lstm_10 must load AFTER lstm_9 — lexicographic sort scrambles 11+
    layer models silently."""
    from svd_lstm_tpu.io.csv_weights import (
        load_model_from_csv,
        save_model_weights_as_csv,
    )
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(7), input_dim=3, units=(4,) * 12)
    d = str(tmp_path / "w")
    save_model_weights_as_csv(params, d)
    loaded = load_model_from_csv(d)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_int8_export_merged_reduced_roundtrips(tmp_path):
    """Merged (non-split) reduced models export as format-v2 kind 'm'
    (round 3; previously rejected) and the oracle reconstructs the same
    encoding the file holds."""
    import svd_lstm_tpu as st
    from svd_lstm_tpu.io.int8_export import dequantized_params, save_model_int8_bin
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    dense = init_stacked_lstm(jax.random.PRNGKey(8), input_dim=4, units=(6,))
    rmodel = st.make_reduced_model(
        st.make_singular_model(dense, merged_kernel=True), rank=4
    )
    path = str(tmp_path / "m.bin")
    nbytes = save_model_int8_bin(rmodel, path)
    assert nbytes == os.path.getsize(path)
    dq = dequantized_params(rmodel)
    assert not dq.layers[0].split  # stays merged
    assert dq.layers[0].wB.shape == np.asarray(rmodel.layers[0].wB).shape
