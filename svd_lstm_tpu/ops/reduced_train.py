"""Kernel-accelerated training path for the truncated (reduced) model.

The reference's workflow ends at truncation: ``make_LSTM_reduced_model``
builds an inference-only cell (every weight ``trainable=False``, reference
code/svd_classes_v3.py:240-368) and accepts whatever accuracy the σ-cutoff
left behind. This module is the beyond-reference recovery stage: the
two-step factors are ordinary parameters here, so the truncated model can
be fine-tuned directly — and routed through the SAME recurrence kernel
pair as the dense trainer (ops/gpu_recurrence.py), exactly like the
singular fine-tune (ops/singular_train.py).

The identity that makes the chain rule exact: with ``B = (U·Σ)·V₁`` and
``C = V₁⁻¹·V₂`` (reference code/svd_classes_v3.py:622-627), the two-step
``concat(x·B, (x·B)·C)`` equals ``x · concat(B, B·C)`` — the dense view

    W~ = [ B | B·C ]        (original column order: V = [V₁ V₂])

is *bilinear* in (B, C), so reconstructing W~ inside the traced step and
differentiating through it yields the exact cotangents

    dB = dW₁ + dW₂ · Cᵀ ,   dC = Bᵀ · dW₂     (dW = [dW₁ | dW₂])

automatically — the custom-VJP dense kernels supply dW/dU/db and XLA
autodiff closes the (once-per-step, tiny) reconstruction chain.
Reconstruction dots run at HIGHEST precision for the same reason the
singular view's do: their product IS the model's weight matrix.

Training B and C directly preserves the two-step *parameterization* (not
just its values), so every deployment surface — the inference paths,
CSV/int8 export, the native consumer — consumes the recovered model
unchanged.
"""

from __future__ import annotations

import jax

from svd_lstm_tpu.models.lstm import StackedLSTMParams
from svd_lstm_tpu.models.reduced import ReducedModelParams
from svd_lstm_tpu.ops.gpu_recurrence import stacked_lstm_apply_fast_train

HIGHEST = jax.lax.Precision.HIGHEST


def reduced_dense_view(rparams: ReducedModelParams) -> StackedLSTMParams:
    """Traced, differentiable dense reconstruction of a reduced model.

    ``x @ [B | B·C] == concat(x·B, (x·B)·C)`` exactly (slide 6-9 algebra,
    reference code/svd_classes_v3.py:317-363), so this view reproduces
    ``reduced_lstm_apply`` through the plain dense forward — and carries
    exact gradients back to every (B, C) factor (fold_IC's identity block
    is a constant, so dB = dW₁ + dW₂·Cᵀ and dC = Bᵀ·dW₂ fall out of
    autodiff unchanged).

    Delegates to ``ops.layouts.reconstruct_dense_model`` — the ONE source
    of the layout-critical [B | B·C] column order — pinning the dots to
    HIGHEST precision (module docstring: the product IS the weight
    matrix, so an ambient bf16 scope must not perturb it).
    """
    from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

    return reconstruct_dense_model(rparams, precision=HIGHEST)


def reduced_lstm_apply_fast_train(
    rparams: ReducedModelParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Drop-in ``apply_fn`` for ``train.loop.fit`` running the
    post-truncation recovery fine-tune through the dense training kernels
    (the stage the reference cannot run at all: its reduced cell is
    frozen, reference code/svd_classes_v3.py:249-315).

    Gradient parity with autodiff of ``reduced_lstm_apply`` is asserted in
    tests/test_reduced_train.py.
    """
    return stacked_lstm_apply_fast_train(
        reduced_dense_view(rparams), x_seq, return_sequences
    )
