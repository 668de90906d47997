"""Kernel-accelerated training paths for the Conv1D+LSTM hybrid families.

The reference trains its conv hybrid end-to-end through Keras
(reference code/old_versions/toy-convolution.py:70-76: Conv1D(15, 10,
causal, relu) -> 2x LSTM(15) -> Dense(1)). Rounds 1-3 trained the
hybrids here on the exact XLA scan only — the ONE family outside the
kernel training engine. This module closes that gap.

The structure that makes it trivial is the same hoisting the inference
path uses (api.predict peels the conv first): the causal conv is a
single whole-sequence ``lax.conv_general_dilated`` with a standard,
XLA-differentiated VJP — there is nothing recurrent about it — so the
hybrid's training step is

    h = relu(causal_conv1d(conv, x))        # one whole-sequence op + its VJP
    y = <stack fast-train apply>(inner, h)  # the recurrence kernel pair

and gradients flow to the conv weights through the kernel's ``dx``
cotangent (the custom-VJP recurrence kernels return dxp, which the
hoisted input projection's autodiff carries back through the conv).

Per-family inner routing (all shared with the pure families — ONE
kernel engine):

* ``ConvLSTMParams``      -> ``ops.gpu_recurrence.stacked_lstm_apply_fast_train``
* ``ConvSingularParams``  -> dense view of the factors
  (``ops.singular_train.singular_dense_view``) through the same kernels
* ``ConvReducedParams``   -> bilinear dense view
  (``ops.reduced_train.reduced_dense_view``) through the same kernels

Dropout fine-tunes keep the XLA scan, exactly like the pure families
(the kernels carry no mask support; train.finetune.dropout_apply_fn
wrappers never identity-match the kernel swap table).
"""

from __future__ import annotations

import jax

from svd_lstm_tpu.models.conv import (
    ConvLSTMParams,
    ConvReducedParams,
    ConvSingularParams,
    causal_conv1d,
)
from svd_lstm_tpu.models.lstm import StackedLSTMParams
from svd_lstm_tpu.ops.gpu_recurrence import stacked_lstm_apply_fast_train


def _conv_front(conv, x_seq: jax.Array) -> jax.Array:
    """relu(causal conv) — the hoisted front end (models/conv.py
    semantics; Keras padding='causal', reference
    code/old_versions/toy-convolution.py:71)."""
    return jax.nn.relu(causal_conv1d(conv, x_seq))


def conv_lstm_apply_fast_train(
    params: ConvLSTMParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Drop-in ``apply_fn`` for ``train.loop.fit`` training the dense conv
    hybrid through the recurrence kernels (the reference's conv
    experiment, code/old_versions/toy-convolution.py:70-76, at kernel
    speed). Gradient parity vs autodiff of ``conv_lstm_apply`` is
    asserted in tests/test_conv_train_kernel.py."""
    h = _conv_front(params.conv, x_seq)
    inner = StackedLSTMParams(layers=params.layers, head=params.head)
    return stacked_lstm_apply_fast_train(inner, h, return_sequences)


def conv_singular_apply_fast_train(
    params: ConvSingularParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Kernel-path fine-tune forward for the factorized conv hybrid: conv
    front end + the singular stack's differentiable dense reconstruction
    through the kernels (ops/singular_train.py). Replaces the hybrid's
    fine-tune-stage compute (the reference fine-tunes factorized models
    only at the pure-LSTM scale, code/svd_acceleration_v3.py:119-128 — the
    hybrid analog is beyond-reference)."""
    from svd_lstm_tpu.ops.singular_train import singular_dense_view

    h = _conv_front(params.conv, x_seq)
    return stacked_lstm_apply_fast_train(
        singular_dense_view(params.inner), h, return_sequences
    )


def conv_reduced_apply_fast_train(
    params: ConvReducedParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Kernel-path recovery fine-tune forward for the truncated conv
    hybrid: conv front end + the reduced stack's bilinear dense view
    through the kernels (ops/reduced_train.py)."""
    from svd_lstm_tpu.ops.reduced_train import reduced_dense_view

    h = _conv_front(params.conv, x_seq)
    return stacked_lstm_apply_fast_train(
        reduced_dense_view(params.inner), h, return_sequences
    )
