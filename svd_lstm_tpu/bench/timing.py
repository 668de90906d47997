"""Host-clock step timing: the first call (compilation included) is set-up,
then the median of ``repeats`` calls, each ended by ``block_until_ready``.

This is the end-to-end number a user feels; ``bench.devtime`` gives the
device's own kernel time from a profiler trace.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, NamedTuple

import jax


class Timing(NamedTuple):
    setup_s: float      # first call: tracing + compilation + one run
    median_ms: float    # median of the timed calls
    runs_ms: tuple      # every timed call


def time_call(fn: Callable, *args, repeats: int = 5) -> Timing:
    """Time ``fn(*args)`` (``fn`` jitted) after one warm-up call."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append((time.perf_counter() - t0) * 1e3)
    return Timing(setup, statistics.median(runs), tuple(runs))
