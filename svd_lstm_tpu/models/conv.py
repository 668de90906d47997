"""Causal-Conv1D + LSTM hybrid regressor.

Parity with the reference's convolutional experiment
(code/old_versions/toy-convolution.py:70-76): Conv1D(filters=15,
kernel_size=10, padding='causal', relu) feeding two stacked 15-unit LSTMs
and a time-distributed Dense(1) head. The conv front-end is a single
``lax.conv_general_dilated`` over the whole sequence — exactly the kind of
large static op that XLA runs well.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svd_lstm_tpu.models.lstm import (
    DenseParams,
    LSTMLayerParams,
    _glorot_uniform,
    init_lstm_layer,
    lstm_layer_apply,
)
from svd_lstm_tpu.models.reduced import ReducedModelParams, reduced_lstm_apply
from svd_lstm_tpu.models.singular import SingularModelParams, singular_lstm_apply


class ConvParams(NamedTuple):
    w: jax.Array  # (kernel_size, in_channels, filters)
    b: jax.Array  # (filters,)


class ConvLSTMParams(NamedTuple):
    conv: ConvParams
    layers: Tuple[LSTMLayerParams, ...]
    head: DenseParams


def causal_conv1d(p: ConvParams, x: jax.Array) -> jax.Array:
    """x: (B, T, C) -> (B, T, filters); left-padded so step t sees only
    inputs ≤ t (Keras padding='causal')."""
    k = p.w.shape[0]
    out = jax.lax.conv_general_dilated(
        x,
        p.w,
        window_strides=(1,),
        padding=[(k - 1, 0)],
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    return out + p.b


def init_conv_lstm(
    key,
    in_channels: int = 1,
    filters: int = 15,
    kernel_size: int = 10,
    units: Sequence[int] = (15, 15),
    head_dim: int = 1,
    dtype=jnp.float32,
) -> ConvLSTMParams:
    keys = jax.random.split(key, len(units) + 2)
    # Keras glorot for conv kernels: fan_in = kernel_size*in_channels,
    # fan_out = kernel_size*filters (receptive-field-scaled, NOT the flat
    # (rows, cols) rule — that gave a ~2.5x wider init than the reference
    # conv experiment, old_versions/toy-convolution.py)
    fan_in = kernel_size * in_channels
    fan_out = kernel_size * filters
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    wk = jax.random.uniform(
        keys[0], (kernel_size, in_channels, filters), dtype, -limit, limit
    )
    conv = ConvParams(w=wk, b=jnp.zeros((filters,), dtype))
    layers = []
    d = filters
    for k_, n in zip(keys[1:-1], units):
        layers.append(init_lstm_layer(k_, d, n, dtype))
        d = n
    head = DenseParams(
        w=_glorot_uniform(keys[-1], (d, head_dim), dtype),
        b=jnp.zeros((head_dim,), dtype),
    )
    return ConvLSTMParams(conv=conv, layers=tuple(layers), head=head)


def conv_lstm_apply(
    params: ConvLSTMParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
    remat_chunk: int = 0,
) -> jax.Array:
    h = jax.nn.relu(causal_conv1d(params.conv, x_seq))
    for layer in params.layers:
        h = lstm_layer_apply(layer, h, remat_chunk=remat_chunk)
    if not return_sequences:
        h = h[:, -1]
    return h @ params.head.w + params.head.b


# ---------------------------------------------------------------------------
# Compressed hybrid families: conv front end + factorized/truncated LSTM stack
# ---------------------------------------------------------------------------
#
# The reference compresses only LSTM kernels (code/svd_classes_v3.py:469-676)
# and trains the conv hybrid as a separate experiment
# (code/old_versions/toy-convolution.py:70-76); these containers close the
# square — every model family the framework can train, it can also
# factorize / truncate / fine-tune / stream. The conv kernel itself is left
# dense: at the reference's size (10×1×15) it is far below any rank the
# two-step could pay for, and XLA already runs the whole-sequence causal
# conv as one large op.


class ConvSingularParams(NamedTuple):
    """Causal-conv front end + SVD-factorized LSTM stack (+ dense head)."""

    conv: ConvParams
    inner: SingularModelParams

    def weight_count(self) -> int:
        return int(sum(x.size for x in jax.tree_util.tree_leaves(self)))


class ConvReducedParams(NamedTuple):
    """Causal-conv front end + truncated two-step LSTM stack (+ dense head)."""

    conv: ConvParams
    inner: ReducedModelParams

    def weight_count(self) -> int:
        return int(sum(x.size for x in jax.tree_util.tree_leaves(self)))


def conv_singular_apply(
    params: ConvSingularParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng: jax.Array | None = None,
    remat_chunk: int = 0,
) -> jax.Array:
    """Hybrid forward: causal conv + relu, then the factorized stack.

    Dropout/remat kwargs pass straight through to ``singular_lstm_apply``
    (the conv front end takes no dropout — Keras applies LSTM dropout to
    the cell inputs, reference code/svd_classes_v3.py:121-127)."""
    h = jax.nn.relu(causal_conv1d(params.conv, x_seq))
    return singular_lstm_apply(
        params.inner,
        h,
        return_sequences,
        dropout=dropout,
        recurrent_dropout=recurrent_dropout,
        rng=rng,
        remat_chunk=remat_chunk,
    )


def conv_reduced_apply(
    params: ConvReducedParams, x_seq: jax.Array, return_sequences: bool = True
) -> jax.Array:
    h = jax.nn.relu(causal_conv1d(params.conv, x_seq))
    return reduced_lstm_apply(params.inner, h, return_sequences)
