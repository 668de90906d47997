"""Configuration dataclasses.

The reference inlines every knob as a constant; this module captures exactly
those knobs (SURVEY.md §5 "Config / flag system"):

* sampling period 500/16 µs        (reference code/svd_acceleration_v3.py:111)
* frame width 16                   (reference code/train_full_model_v4.py:65)
* train/test split at t = 30.7 s   (reference code/train_full_model_v4.py:72)
* units [40, 40, 40, 40]           (reference code/train_full_model_v4.py:102)
* 20 000 windows × 200 steps       (reference code/train_full_model_v4.py:120)
* 30 epochs adam + MSE             (reference code/train_full_model_v4.py:116-126)
* hoyer = 0.01, cutoff = 0.05      (reference code/svd_acceleration_v3.py:117,145)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DROPBEAR preprocessing knobs (reference code/train_full_model_v4.py:24-80)."""

    sampling_period: float = 500 / 16 * 1e-6   # seconds between raw samples
    frame_width: int = 16                      # samples per LSTM step
    start_time: float = 1.5                    # drop everything before t=1.5 s
    split_time: float = 30.7                   # train/test boundary (seconds)
    json_path: str = "data_6_with_FFT.json"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Stacked-LSTM regressor structure (reference code/train_full_model_v4.py:102-115)."""

    input_dim: int = 16
    units: Sequence[int] = (40, 40, 40, 40)
    head_dim: int = 1
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Windowed-BPTT training knobs (reference code/train_full_model_v4.py:116-126)."""

    num_windows: int = 20_000
    window_len: int = 200
    batch_size: int = 32
    epochs: int = 30
    learning_rate: float = 1e-3     # keras adam default
    seed: int = 0
    nan_rollback: bool = True       # reference old_versions/train_full_model.py:133-136
    checkpoint_dir: str = "./model_saves"
    # Matmul passes inside the train step: "float32" (exact, default),
    # "tensorfloat32" (TF32 on the GPU's tensor cores), or "bfloat16";
    # validation metrics always run exact. Speed of each: PERF.md.
    matmul_precision: str = "float32"
    # Run the training recurrences through the custom-VJP recurrence kernel
    # pair (ops/gpu_recurrence.py) for stacks whose layers are all at most
    # 128 units wide; wider stacks keep the lax.scan. In-kernel dots are
    # TF32. Applies to dense training, the singular fine-tune and the
    # post-truncation recovery (via the differentiable dense views in
    # ops/singular_train.py / ops/reduced_train.py) and the conv hybrids;
    # dropout fine-tunes keep the XLA scan.
    recurrence_kernel: bool = False
    # Consult the autotune cache for this (model, window shape, device)
    # before training and, on a hit, train with the measured-best
    # (matmul_precision, recurrence_kernel) pair written
    # by `tune --train` / `tuned_train_flags` — the training analog of
    # ``predict(impl="auto")`` consulting its cache. Read-only: a cache
    # miss trains with THIS config's flags, never measures. Explicit flags
    # set here are overridden on a hit (the point is tune-once,
    # train-measured-best-thereafter).
    auto_flags: bool = False
    # Chunked-time activation rematerialization for the XLA-scan train step
    # (jax.checkpoint around inner scans of this many steps): BPTT then
    # saves only raw input chunks + chunk-boundary (h, c) carries and
    # recomputes projections/gates on the backward pass — O(T/K + K) live
    # activation memory instead of O(T), ~2x extra forward FLOPs, identical
    # values. Enables window lengths whose saved activations exceed HBM
    # (the reference caps context at 200 steps purely by windowing,
    # code/svd_acceleration_v3.py:113 — this removes the memory half of
    # that cap). 0 = off. Ignored when recurrence_kernel takes the step
    # (the kernel pair has its own fixed residual plan).
    remat_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class FactorConfig:
    """SVD factorization / fine-tune knobs (reference code/svd_acceleration_v3.py:117-145)."""

    merged_kernel: bool = False     # split (per-gate) factorization is the driver default
    hoyer: float = 0.01             # Hoyer L1/L2 coefficient on σ vectors
    # Beyond-reference alternative sparsifier: L1 on σ == the nuclear/trace
    # norm of the factorized matrix (factor/regularizers.trace_norm_penalty,
    # arxiv 1710.09026). Composable with hoyer; 0 = off. NB: hoyer defaults
    # ON (0.01, the reference driver's setting) — pass hoyer=0.0 alongside
    # trace_norm for a pure trace-norm fine-tune. Measured guidance
    # (scripts/sparsifier_comparison.py): 3e-4 removes ~2.3× more weights
    # than hoyer=0.01 at small RMSE cost; ≥1e-3 damages accuracy.
    trace_norm: float = 0.0
    orthogonal: float = 0.0         # orthogonality penalty on U/V factors; >0 => train U/V
    train_uv: bool = False
    cutoff: float = 0.05            # σ truncation threshold
    finetune_epochs: int = 10
    finetune_batch_size: int = 32
    # Keras-semantics dropout during the fine-tune: masks on the cell inputs
    # / on h_{t-1}, constant across time, fresh per batch (reference
    # SingularLSTMCell dropout support, code/svd_classes_v3.py:121-137).
    dropout: float = 0.0
    recurrent_dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Rank-reduction sweep knobs (reference code/old_versions/svd_acceleration.py:61-88)."""

    protect_first_layer_w: bool = True   # reference :67-68
    evaluate_every: int = 1
    threshold: float | None = None       # stop when RMSE ratio exceeds this
