"""User-facing profiler trace capture and op-level breakdown.

The reference's only profiling instrument was ``time.perf_counter`` around
``model.predict`` (code/svd_acceleration_v3.py:147-152) — one number per
run, nothing about *where* the time went. This module is the profiler
upgrade: it persists a real ``jax.profiler`` trace (viewable in
TensorBoard's profile plugin or Perfetto) and extracts an aggregated
per-op device-time table from it, so "the reduced model is slower" becomes
"the reduced model spends 62% of its time in per-gate 15×16 matmuls".

``bench.devtime`` remains the measurement primitive (the summed kernel
time on the GPU device planes); this module is the diagnostic surface:
named, persistent traces plus the breakdown.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Callable, NamedTuple, Sequence

import jax

from svd_lstm_tpu.bench import devtime


def trace_events(trace_dir: str) -> list:
    """Complete ('X') events of the newest ``.trace.json.gz`` under a
    ``jax.profiler.trace`` directory (host and device rows alike)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")))
    if not paths:
        raise RuntimeError(f"no trace produced under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        data = json.loads(f.read())
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def device_ms_of(trace_dir: str) -> float:
    """The call's device time: ``devtime.kernel_ms`` of the trace."""
    return devtime.kernel_ms(devtime.load_trace(trace_dir))


class OpStat(NamedTuple):
    """Aggregated device time for one op/event name."""

    name: str
    count: int
    total_ms: float


# Event names that are profiler/runtime scaffolding, not workload:
# host-side dispatch wrappers (PjitFunction/PJRT/ParseArguments span the
# whole call including dispatch, so they'd dwarf and double-count the
# actual executable events), the top-level jit_* executable wrapper (it IS
# the device total — listing it as an op row would double-count every
# child op against itself), and profiler internals.
_SCAFFOLD_PREFIXES = (
    "$",
    "process_",
    "XlaModule",
    "thread_",
    "PjitFunction",
    "PJRT_",
    "ParseArguments",
    "PythonRefManager",
    "jit_",
)
_SCAFFOLD_SUBSTRINGS = ("profiler", "TraceMe", "Xprof")


def _is_workload_event(name: str) -> bool:
    if not name:
        return False
    if any(name.startswith(p) for p in _SCAFFOLD_PREFIXES):
        return False
    return not any(s in name for s in _SCAFFOLD_SUBSTRINGS)


def capture_trace(fn: Callable, *args, out_dir: str, warmup: int = 1) -> str:
    """Run ``fn(*args)`` under ``jax.profiler.trace`` into ``out_dir``.

    ``fn`` should be jitted; its output is blocked on inside the trace so
    the trace covers exactly one dispatch. Returns ``out_dir``. View with
    ``tensorboard --logdir OUT_DIR`` (profile plugin) or by loading the
    ``*.trace.json.gz`` into https://ui.perfetto.dev.
    """
    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn(*args))
    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        jax.block_until_ready(fn(*args))
    return out_dir


def op_breakdown(trace_dir, top: int = 0) -> list[OpStat]:
    """Aggregate complete ('X') events in a captured trace by name.

    ``trace_dir`` is a trace directory (from :func:`capture_trace` or any
    ``jax.profiler.trace`` output) or an already-parsed event list. Returns
    stats sorted by total duration, descending; ``top`` truncates (0 =
    all). Scaffolding events (profiler internals, process metadata, the
    top-level jit_* wrapper) are dropped.
    """
    events = (
        trace_dir
        if not isinstance(trace_dir, (str, os.PathLike))
        else trace_events(trace_dir)
    )
    totals: dict[str, list[float]] = {}
    for e in events:
        name = str(e.get("name", ""))
        if not _is_workload_event(name):
            continue
        acc = totals.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.get("dur", 0) / 1000.0
    stats = sorted(
        (OpStat(n, int(c), t) for n, (c, t) in totals.items()),
        key=lambda s: -s.total_ms,
    )
    return stats[:top] if top else stats


def format_breakdown(stats: Sequence[OpStat], total_ms: float | None = None) -> str:
    """Render an op table. ``total_ms`` adds a % column (device total)."""
    if not stats:
        return "(no workload events in trace)"
    width = min(max(len(s.name) for s in stats), 60)
    lines = [f"{'op':<{width}}  {'count':>6}  {'ms':>10}" + ("  {:>6}".format("%") if total_ms else "")]
    for s in stats:
        name = s.name if len(s.name) <= width else s.name[: width - 1] + "…"
        row = f"{name:<{width}}  {s.count:>6}  {s.total_ms:>10.3f}"
        if total_ms:
            row += f"  {100.0 * s.total_ms / total_ms:>5.1f}%"
        lines.append(row)
    return "\n".join(lines)


def summarize(fn: Callable, *args, out_dir: str, top: int = 15, warmup: int = 1) -> dict:
    """Capture a trace of ``fn(*args)`` and summarize it in one call.

    Returns ``{"trace_dir", "device_ms", "ops": [OpStat...]}`` where
    ``device_ms`` is the summed kernel time on the GPU device planes
    (:func:`device_ms_of`, which raises off the GPU) and ``ops`` the
    aggregated breakdown.
    """
    capture_trace(fn, *args, out_dir=out_dir, warmup=warmup)
    return {
        "trace_dir": out_dir,
        "device_ms": device_ms_of(out_dir),
        "ops": op_breakdown(trace_events(out_dir), top=top),
    }
