"""bench.trace: persistent profiler capture + per-op breakdown (the
diagnostic upgrade of the reference's perf_counter-only timing,
code/svd_acceleration_v3.py:147-152). Runs on the CPU profiler — events
are host-side but the capture/parse/aggregate path is identical. The
device total needs a GPU device plane, so CPU tests inject it."""

import os

import jax
import jax.numpy as jnp
import pytest

import svd_lstm_tpu.bench.trace as trace_mod
from svd_lstm_tpu.__main__ import _trace
from svd_lstm_tpu.bench.trace import (
    OpStat,
    capture_trace,
    format_breakdown,
    op_breakdown,
    summarize,
)


@pytest.fixture()
def fake_device_ms(monkeypatch):
    """Stand-in for the GPU device-plane total (CPU traces have none)."""
    monkeypatch.setattr(trace_mod, "device_ms_of", lambda trace_dir: 1.5)


def _toy_fn():
    @jax.jit
    def f(a, b):
        return jnp.tanh(a @ b).sum()

    k = jax.random.PRNGKey(0)
    a = jax.random.normal(k, (64, 64))
    return f, (a, a)


def test_capture_trace_persists_and_breaks_down(tmp_path):
    f, args = _toy_fn()
    out = capture_trace(f, *args, out_dir=str(tmp_path / "tr"))
    assert os.path.isdir(out)
    # a real trace file landed
    found = []
    for root, _, files in os.walk(out):
        found += [f for f in files if f.endswith(".trace.json.gz")]
    assert found, "no trace file produced"

    stats = op_breakdown(out)
    assert stats and all(isinstance(s, OpStat) for s in stats)
    assert all(s.total_ms >= 0 and s.count >= 1 for s in stats)
    # sorted descending by total
    totals = [s.total_ms for s in stats]
    assert totals == sorted(totals, reverse=True)
    # scaffolding filtered — including the top-level jit_* wrapper, which
    # is the device total and would double-count every child op against
    # itself if listed as an op row
    assert not any(s.name.startswith(("$", "jit_")) or "profiler" in s.name for s in stats)
    # top truncation
    assert len(op_breakdown(out, top=1)) == 1


def test_summarize_and_format(tmp_path, fake_device_ms):
    f, args = _toy_fn()
    s = summarize(f, *args, out_dir=str(tmp_path / "tr"), top=5)
    assert s["device_ms"] > 0
    assert 0 < len(s["ops"]) <= 5
    table = format_breakdown(s["ops"], total_ms=s["device_ms"])
    assert s["ops"][0].name[:20] in table.split("\n")[1]
    assert "%" in table
    assert format_breakdown([]) == "(no workload events in trace)"


def test_cli_trace_random_model(tmp_path, capsys, fake_device_ms):
    _trace([str(tmp_path / "tr"), "--steps", "8", "--top", "5"])
    out = capsys.readouterr().out
    assert "device total:" in out
    assert "trace ->" in out


def test_cli_trace_reduced_checkpoint(tmp_path, capsys, fake_device_ms):
    """trace works on a non-dense checkpoint: it must derive the input
    width from the family-generic input_dim property, not from a dense
    layer's W.shape. Regression: reduced/singular checkpoints crashed on
    the dense-only attribute."""
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu.io.checkpoint import save_params
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    dense = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=6, units=(8, 8))
    rmodel = make_reduced_model(make_singular_model(dense), rank=5)
    ckpt = str(tmp_path / "reduced.npz")
    save_params(ckpt, rmodel)
    _trace([str(tmp_path / "tr"), "--checkpoint", ckpt, "--steps", "8", "--top", "5"])
    out = capsys.readouterr().out
    assert "device total:" in out


def test_big_trace_breakdown_uses_full_parse(tmp_path):
    """op_breakdown parses every event of a recorded trace — including
    events whose args object sits between name and dur — and drops the
    jit_* wrappers, so the table never degenerates to one wrapper row."""
    import gzip
    import json as _json

    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    events = [
        {"ph": "X", "name": "jit_f", "dur": 1000.0},
        {"ph": "X", "name": "jit_g", "args": {"run_id": 1}, "dur": 250.0},
        {"ph": "X", "name": "fusion.1", "args": {"run_id": 1}, "dur": 600.0},
        {"ph": "X", "name": "while.2", "dur": 400.0},
        {"ph": "X", "name": "while.2", "dur": 100.0},
    ]
    with gzip.open(d / "host.trace.json.gz", "wb") as f:
        f.write(_json.dumps({"traceEvents": events}).encode())

    assert len(trace_mod.trace_events(str(tmp_path))) == 5
    stats = op_breakdown(str(tmp_path))
    assert [(s.name, s.count, s.total_ms) for s in stats] == [
        ("fusion.1", 1, 0.6), ("while.2", 2, 0.5)
    ]


def test_summarize_device_total_needs_gpu_plane(tmp_path):
    """Off the GPU the trace has no device plane: the device total raises
    instead of guessing from host events."""
    f, args = _toy_fn()
    with pytest.raises(RuntimeError, match="no kernel events"):
        summarize(f, *args, out_dir=str(tmp_path / "tr"))
