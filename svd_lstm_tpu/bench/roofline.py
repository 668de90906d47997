"""Shape-derived work counts and the device roofline.

Everything here is computed from shapes alone: the multiply-accumulates
(MACs) a step needs and the bytes it must move. Dividing by a device's
published peaks gives the least time the device could take (the roofline);
dividing that by a measured time gives the roofline share. Measured times
come only from runs on the card.

``PEAKS`` is keyed by ``jax.Device.device_kind``; a device that is not in
the table is an error, not a default.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from svd_lstm_tpu.ops.gpu_recurrence import BLOCK_ROWS, gate_width


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one device."""

    bf16_flops: float
    tf32_flops: float
    f32_flops: float       # outside the tensor cores
    hbm_bytes_per_s: float
    source: str


_H100_SXM = Peaks(
    bf16_flops=989e12,
    tf32_flops=495e12,
    f32_flops=67e12,
    hbm_bytes_per_s=3.35e12,
    source="NVIDIA H100 SXM data sheet (dense, at the 700 W limit)",
)

PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM}

# Which peak a matmul precision runs at on the tensor cores.
_PRECISION_PEAK = {"bfloat16": "bf16_flops", "tensorfloat32": "tf32_flops",
                   "float32": "f32_flops"}


def peaks(device_kind: str) -> Peaks:
    """The peaks of ``device_kind``; raises for a device not in the table."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        )
    return PEAKS[device_kind]


def roofline_ms(macs: float, nbytes: float, pk: Peaks, precision: str = "float32"):
    """(least time in ms, bound) for ``macs`` and ``nbytes`` on ``pk``:
    the larger of compute over the peak of ``precision`` and bytes over
    the memory bandwidth; ``bound`` says which."""
    flops = getattr(pk, _PRECISION_PEAK[precision])
    compute = 2 * macs / flops * 1e3
    memory = nbytes / pk.hbm_bytes_per_s * 1e3
    return (compute, "compute") if compute >= memory else (memory, "memory")


@dataclasses.dataclass
class StepCost:
    """Work of one batch-1 time step of the whole stack."""

    bytes_streamed: int   # recurrent weights read per step (f32)
    macs: int             # x-side + h-side MACs per step
    stages: int = 0       # dependent products on the per-step chain

    def bandwidth_floor_us(self, pk: Peaks = _H100_SXM) -> float:
        return self.bytes_streamed / pk.hbm_bytes_per_s * 1e6

    def compute_floor_us(self, pk: Peaks = _H100_SXM) -> float:
        return 2 * self.macs / pk.f32_flops * 1e6


def dense_step_cost(input_dim: int, units: Sequence[int]) -> StepCost:
    """Per-step MACs of a dense stack and the recurrent-weight bytes a
    step reads if nothing stays on chip (one (n, 4n) f32 U per layer)."""
    macs = 0
    nbytes = 0
    d = input_dim
    for n in units:
        macs += d * 4 * n + n * 4 * n
        nbytes += n * 4 * n * 4
        d = n
    return StepCost(bytes_streamed=nbytes, macs=macs, stages=len(units))


def reduced_step_cost(
    input_dim: int,
    units: Sequence[int],
    ranks: Sequence[int],
    merged: bool = True,
) -> StepCost:
    """Per-step work of the two-step reduced cell ((v@B)@[I|C] per side,
    per matrix when merged, per gate when split)."""
    macs = 0
    nbytes = 0
    d = input_dim
    for n, r in zip(units, ranks):
        if merged:
            macs += d * r + r * 4 * n + n * r + r * 4 * n
            nbytes += (n * r + r * 4 * n) * 4
        else:
            macs += 4 * (d * r + r * n + n * r + r * n)
            nbytes += 4 * (n * r + r * n) * 4
        d = n
    # two dependent products per layer on the chain (h@B, then (hB)@[I|C])
    return StepCost(bytes_streamed=nbytes, macs=macs, stages=2 * len(units))


def report(cost: StepCost, measured_us_per_step: float | None = None,
           pk: Peaks = _H100_SXM) -> str:
    lines = [
        f"recurrent weights/step: {cost.bytes_streamed/1024:.1f} KiB -> "
        f"memory roofline {cost.bandwidth_floor_us(pk)*1e3:.2f} ns/step",
        f"MACs/step: {cost.macs} -> f32 compute roofline "
        f"{cost.compute_floor_us(pk)*1e3:.3f} ns/step",
        f"chain: {cost.stages} dependent products per step",
    ]
    if measured_us_per_step is not None:
        lines.append(f"measured: {measured_us_per_step*1e3:.1f} ns/step")
    return "\n".join(lines)


@dataclasses.dataclass
class TrainStepCost:
    macs_model: int      # 3x the forward's algorithmic MACs (MFU convention)
    macs_executed: int   # MACs the kernel path issues (padding + recompute)
    hbm_bytes: int       # activation bytes the recurrence kernels move

    def mfu(self, measured_ms: float, peak_flops: float) -> float:
        """Model FLOP/s utilization against ``peak_flops``."""
        return 2 * self.macs_model / (measured_ms * 1e-3) / peak_flops


def _model_train_macs(input_dim: int, units: Sequence[int], B: int, T: int) -> int:
    """3x the forward's algorithmic MACs (standard training-FLOPs count)."""
    fwd = 0
    d = input_dim
    for n in units:
        fwd += B * T * (d * 4 * n + n * 4 * n)
        d = n
    return 3 * fwd


def train_step_cost(
    input_dim: int, units: Sequence[int], B: int, T: int
) -> TrainStepCost:
    """One training step through the recurrence kernel pair
    (ops/gpu_recurrence.py). Per layer-step each program issues 4 forward
    dots and 8 backward dots (4 gate recomputes, 4 for dh), each
    (Bp, G) x (G, G) with Bp the batch padded to 16-row tiles and G the
    gate width; the hoisted x-side products, dW and dU run unpadded in
    XLA. The kernels stream 6 G-wide f32 rows forward (xp in, h and c out)
    and 12 backward (xp, h_prev, c_prev, c, dh in; dxp out)."""
    Bp = -(-B // BLOCK_ROWS) * BLOCK_ROWS
    macs = 0
    nbytes = 0
    d = input_dim
    for n in units:
        G = gate_width(n)
        macs += 12 * Bp * T * G * G            # kernel dots
        macs += 3 * B * T * d * 4 * n          # x-side fwd, dW, dx
        macs += B * T * n * 4 * n              # dU
        nbytes += 18 * Bp * T * G * 4
        d = n
    return TrainStepCost(
        macs_model=_model_train_macs(input_dim, units, B, T),
        macs_executed=macs,
        hbm_bytes=nbytes,
    )
