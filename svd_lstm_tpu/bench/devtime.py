"""Device time of one call, from the profiler's GPU device planes.

A ``jax.profiler`` trace of a call on the GPU holds one plane per card,
named ``/device:GPU:<i>``, whose ``Stream #<n>(...)`` lines carry one event
per kernel that ran on the card (XLA's fusions, cuBLAS products, the Pallas
kernels under their own names). The device time of a call is the sum of
those kernel durations. Host planes (``/host:CPU``) hold dispatch spans,
not device work, and are never counted.

There is no fallback: a trace without a GPU device plane, or with no kernel
on it, raises.
"""

from __future__ import annotations

import glob
import os
import tempfile
from typing import Callable

import jax

DEVICE_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream"


def kernel_events(pdata):
    """(plane name, line name, event) for every kernel event on the GPU
    device planes of a ``jax.profiler.ProfileData``."""
    for plane in pdata.planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if line.name.startswith(STREAM_LINE_PREFIX):
                for ev in line.events:
                    yield plane.name, line.name, ev


def kernel_ms(pdata) -> float:
    """Summed kernel time (ms) on the GPU device planes of a trace; raises
    when the trace holds none."""
    planes = [p.name for p in pdata.planes]
    total_ns = 0.0
    count = 0
    for _, _, ev in kernel_events(pdata):
        total_ns += ev.duration_ns
        count += 1
    if not count:
        raise RuntimeError(
            f"no kernel events on a {DEVICE_PLANE_PREFIX}* plane (planes: {planes})"
        )
    return total_ns / 1e6


def load_trace(trace_dir: str):
    """The newest ``.xplane.pb`` under a ``jax.profiler.trace`` directory."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))
    if not paths:
        raise RuntimeError(f"no trace produced under {trace_dir}")
    return ProfileData.from_file(paths[-1])


def device_time_ms(fn: Callable, *args, warmup: int = 1, repeats: int = 3) -> float:
    """Best-of-``repeats`` summed kernel time of one ``fn(*args)`` call, in
    ms. ``fn`` should be jitted; its output is blocked on inside the trace.
    Needs the GPU: on any other platform the trace has no device plane and
    this raises."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        with tempfile.TemporaryDirectory() as td:
            with jax.profiler.trace(td):
                jax.block_until_ready(fn(*args))
            best = min(best, kernel_ms(load_trace(td)))
    return best
