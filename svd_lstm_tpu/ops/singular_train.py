"""Kernel-accelerated training path for the SVD-factorized (singular) model.

The reference's central compression stage is a 10-epoch fine-tune of the
factorized model (reference code/svd_acceleration_v3.py:119-128). Round 2
left it on the exact XLA scan; this module routes it through the SAME
recurrence kernel pair the dense trainer uses (ops/gpu_recurrence.py),
with exact gradients for every factor:

    W = (U_w · diag(σ_w)) · V_wᵀ   (per matrix, or per gate when split)

is *linear* in each factor, so reconstructing the dense weights inside
the traced step and differentiating through the reconstruction gives the
exact chain-rule cotangents

    dσ = diag(U_wᵀ · dW · V_w),   dU_w = dW · V_w · diag(σ),
    dV_wᵀ = diag(σ) · U_wᵀ · dW

automatically — the custom-VJP kernels supply dW/dU/db and XLA autodiff
closes the (tiny, once-per-step) reconstruction chain. No factored
recurrence kernel is needed: the reconstruction costs two (d×d)@(d×4n)
dots per layer per step, ~1e-3 of the T=200-step recurrence work.

Reconstruction dots run at HIGHEST precision: their product *is* the
model's weight matrix, so a relaxed pass here would perturb the weights
themselves rather than relax an activation pass.

The σ-only trainable masking stays in the optimizer
(train/finetune.py `make_finetune_optimizer`) — gradients are computed
for every factor and zeroed by the mask, exactly as on the scan path.

Dropout fine-tunes keep the XLA scan: the per-gate mask semantics
(reference code/svd_classes_v3.py:121-137) need the factored forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import LSTMLayerParams, StackedLSTMParams
from svd_lstm_tpu.models.singular import SingularModelParams
from svd_lstm_tpu.ops.gpu_recurrence import stacked_lstm_apply_fast_train

HIGHEST = jax.lax.Precision.HIGHEST


def _dense_matrix(left, sigma, right):
    """(left · diag(sigma)) · right, merged (2-D) or per-gate (3-D stacked).

    merged: left (d, k), sigma (k,), right (k, 4n) -> (d, 4n)
    split:  left (4, d, k), sigma (4, k), right (4, k, n) -> (d, 4n)
            with gate blocks [i|f|c|o] concatenated along columns, matching
            the Keras layout models/lstm.py stores (reference
            code/svd_classes_v3.py:146-232 keeps per-gate factors).
    """
    if left.ndim == 3:
        scaled = left * sigma[:, None, :]                      # (4, d, k)
        per_gate = jnp.einsum("gdk,gkn->gdn", scaled, right,
                              precision=HIGHEST)               # (4, d, n)
        d = per_gate.shape[1]
        return jnp.transpose(per_gate, (1, 0, 2)).reshape(d, -1)
    return jnp.dot(left * sigma, right, precision=HIGHEST)


def singular_dense_view(sparams: SingularModelParams) -> StackedLSTMParams:
    """Traced, differentiable dense reconstruction of a singular model.

    Same math as ``factor.svd.singular_to_dense`` (which shares
    ``_dense_matrix`` but casts to a target dtype for export); this
    cast-free view is the gradient path — dW/dU from the dense kernels
    flows back to (wl, ws, wr, ul, us, ur) — the factored-training
    replacement for the reference's per-weight ``trainable`` flags
    (reference code/svd_classes_v3.py:51-112).
    """
    layers = tuple(
        LSTMLayerParams(
            W=_dense_matrix(p.wl, p.ws, p.wr),
            U=_dense_matrix(p.ul, p.us, p.ur),
            b=p.b,
        )
        for p in sparams.layers
    )
    return StackedLSTMParams(layers=layers, head=sparams.head)


def singular_lstm_apply_fast_train(
    sparams: SingularModelParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Drop-in ``apply_fn`` for ``train.loop.fit`` running the singular
    fine-tune through the fused dense training kernels.

    Replaces the reference fine-tune stage's compute
    (code/svd_acceleration_v3.py:119-128) at kernel speed; gradient parity
    with autodiff of ``singular_lstm_apply`` is asserted in
    tests/test_singular_train_kernel.py.
    """
    return stacked_lstm_apply_fast_train(
        singular_dense_view(sparams), x_seq, return_sequences
    )
