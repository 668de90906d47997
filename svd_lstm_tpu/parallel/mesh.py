"""Device-mesh helpers.

The reference has no distributed execution of any kind (SURVEY.md §2: the
custom Keras cells are explicitly CPU-bound single-process). Here: a
``jax.sharding.Mesh`` with a data axis (``dp``) and a model axis (``tp``),
used by ``svd_lstm_tpu.parallel.train`` for batch-parallel windowed-BPTT
with gate-column tensor parallelism. The devices are reshaped in order:
every card of a host reaches every other at the same NVLink rate, so the
mesh follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """Create a (dp, tp) mesh. Defaults: tp=1, dp=all devices / tp."""
    devices = list(devices if devices is not None else jax.devices())
    if dp is None:
        dp = len(devices) // tp
    if dp * tp > len(devices):
        raise ValueError(f"need {dp*tp} devices, have {len(devices)}")
    arr = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
