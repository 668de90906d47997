"""Magnitude pruning of the singular model's trainable kernels (C13 parity).

The reference's abandoned experiment wraps its singular layers in tfmot's
``prune_low_magnitude`` with a ``PolynomialDecay(0 -> 0.5, 5000 steps)``
schedule (reference code/svd_acceleration_v3.py:101-108, wiring
code/svd_acceleration_v2.py:87-108, ``PrunableTimeDistributed``
code/svd_classes_v3.py:442-449; abandoned — "pruning was a bad idea",
code/svd_acceleration_v2.py:111). In the singular model, the *prunable*
weights (``get_prunable_weights``, reference code/svd_classes_v3.py:439-440)
are the layer's ``kernel``/``recurrent_kernel`` — which hold the σ vectors.
So the functional analog is direct: per-tensor magnitude masks on every σ
vector, tightening along a polynomial schedule while fine-tuning.

This is deliberately a thin functional wrapper: pruning here is a
*reversible mask on σ*, so a pruned singular model flows through the normal
σ-cutoff truncation (``make_reduced_model``) unchanged — a zeroed σ is
simply below every cutoff. Structural compression that shrinks the
executed shapes lives in ``factor/prune_units.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from svd_lstm_tpu.models.singular import SingularLayerParams, SingularModelParams


@dataclasses.dataclass(frozen=True)
class PolynomialDecaySchedule:
    """tfmot ``PolynomialDecay`` parity: sparsity ramps from
    ``initial_sparsity`` at ``begin_step`` to ``final_sparsity`` at
    ``end_step`` following ``1 - (1 - t)^power`` (reference experiment used
    0 -> 0.5 over 5000 steps, code/svd_acceleration_v3.py:104-106)."""

    initial_sparsity: float = 0.0
    final_sparsity: float = 0.5
    begin_step: int = 0
    end_step: int = 5000
    power: int = 3

    def __call__(self, step: int) -> float:
        if step < self.begin_step:
            return 0.0
        t = min(1.0, (step - self.begin_step) / max(1, self.end_step - self.begin_step))
        return self.final_sparsity + (self.initial_sparsity - self.final_sparsity) * (
            (1.0 - t) ** self.power
        )


def magnitude_mask(values: np.ndarray, sparsity: float) -> np.ndarray:
    """Per-tensor magnitude mask: zero the smallest-|v| ``sparsity`` fraction
    (tfmot semantics — each weight tensor is pruned independently)."""
    v = np.asarray(values)
    k = int(np.floor(sparsity * v.size))
    mask = np.ones(v.shape, v.dtype)
    if k <= 0:
        return mask
    order = np.argsort(np.abs(v), axis=None, kind="stable")
    mask.flat[order[:k]] = 0.0
    return mask


def prune_sigmas(sparams, sparsity: float):
    """Zero the smallest-magnitude ``sparsity`` fraction of every σ vector
    (per tensor: each layer's σ_w and σ_u independently). Accepts the conv
    hybrid (``ConvSingularParams``) — only the factorized stack prunes."""
    if hasattr(sparams, "inner"):  # ConvSingularParams
        return sparams._replace(inner=prune_sigmas(sparams.inner, sparsity))

    def prune_layer(layer: SingularLayerParams) -> SingularLayerParams:
        ws = np.asarray(layer.ws)
        us = np.asarray(layer.us)
        return layer._replace(
            ws=layer.ws * magnitude_mask(ws, sparsity),
            us=layer.us * magnitude_mask(us, sparsity),
        )

    return SingularModelParams(
        layers=tuple(prune_layer(l) for l in sparams.layers), head=sparams.head
    )


def sigma_sparsity(sparams) -> float:
    """Fraction of exactly-zero entries across every σ vector."""
    total = zeros = 0
    if hasattr(sparams, "inner"):  # ConvSingularParams
        sparams = sparams.inner
    for layer in sparams.layers:
        for v in (np.asarray(layer.ws), np.asarray(layer.us)):
            total += v.size
            zeros += int((v == 0.0).sum())
    return zeros / total


def finetune_with_pruning(
    sparams,
    X_train,
    y_train,
    schedule: PolynomialDecaySchedule = PolynomialDecaySchedule(),
    steps_per_epoch: int | None = None,
    **finetune_kwargs,
):
    """Fine-tune with the pruning mask re-applied after every epoch at the
    schedule's current sparsity. Granularity difference vs tfmot,
    documented honestly: tfmot zeroes masked weights *every train step*
    (``UpdatePruningStep``), so pruned weights cannot move between mask
    updates; here σ's pruned at an epoch boundary may regrow *within* the
    following epoch before the (recomputed, tighter) mask re-zeroes them.
    For the monotone polynomial schedule the end state is the same masked
    sparsity level. Optimizer state (adam moments) carries across epochs —
    the loop is one continuous fine-tune, as in tfmot — and ``history``
    accumulates every epoch's loss.
    """
    from svd_lstm_tpu.config import FactorConfig, TrainConfig
    from svd_lstm_tpu.train.finetune import finetune

    factor_cfg = finetune_kwargs.pop("factor_cfg", FactorConfig())
    train_cfg = finetune_kwargs.pop("train_cfg", None)
    if train_cfg is None:
        train_cfg = TrainConfig(
            epochs=factor_cfg.finetune_epochs,
            batch_size=factor_cfg.finetune_batch_size,
        )
    if steps_per_epoch is None:
        steps_per_epoch = max(1, train_cfg.num_windows // train_cfg.batch_size)

    # ONE window set for the whole loop, exactly like a single continuous
    # finetune(epochs=N) — per-epoch finetune calls would otherwise
    # resample a fresh window set (different data than plain finetune) and
    # re-ship ~256 MB to device every epoch. Each epoch still gets its own
    # shuffle: fit permutes with (seed + epoch), and `one` below carries
    # seed + epoch.
    if "windows" not in finetune_kwargs:
        from svd_lstm_tpu.data.batcher import split_train_random

        finetune_kwargs["windows"] = split_train_random(
            X_train, y_train, train_cfg.num_windows, train_cfg.window_len,
            seed=train_cfg.seed,
        )

    params = sparams
    result = None
    history, val_history = [], []
    rollbacks = 0
    opt_state = None
    for epoch in range(train_cfg.epochs):
        one = dataclasses.replace(train_cfg, epochs=1, seed=train_cfg.seed + epoch)
        result = finetune(
            params, X_train, y_train,
            factor_cfg=factor_cfg, train_cfg=one,
            init_opt_state=opt_state, **finetune_kwargs,
        )
        opt_state = result.opt_state
        history.extend(result.history)
        val_history.extend(result.val_history or [])
        rollbacks += result.rollbacks
        sparsity = schedule((epoch + 1) * steps_per_epoch)
        params = prune_sigmas(result.params, sparsity)
    if result is not None:
        result.params = params
        result.history = history
        result.val_history = val_history or result.val_history
        # rollbacks from EVERY epoch, not just the last one's TrainResult
        result.rollbacks = rollbacks
    return result
