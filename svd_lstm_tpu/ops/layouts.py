"""Kernel-layout transformations for reduced models.

A reduced model's *parameterization* (the exact two-step (B, C) pairs —
reference code/svd_classes_v3.py:604-676) is independent of the *layout*
it executes in:

* **x-side (input projections)**: stays factored — these run as large
  (T × d) @ (d × r) @ (r × ·) matmuls over the whole sequence, where the
  rank reduction is a real FLOP/bandwidth saving.
* **h-side (recurrence)**: can run *dense-reconstructed*: ``U_rec = B @
  [I|C]`` is algebraically exact (same outputs up to one matmul rounding)
  and costs one dependent product per step instead of two.

Which layout is faster is a measurement per width (PERF.md); this module
only provides the exact transformations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import gate_update
from svd_lstm_tpu.models.reduced import ReducedModelParams, reduced_projection
from svd_lstm_tpu.utils.linalg import fold_IC


def reconstruct_recurrent_dense(layer, precision=None) -> jax.Array:
    """(n, 4n) dense recurrent kernel from (B, C) pairs — exact."""
    if layer.split:
        blocks = [
            jnp.dot(B, fold_IC(B, C), precision=precision)
            for B, C in zip(layer.uB, layer.uC)
        ]
        return jnp.concatenate(blocks, axis=1)
    return jnp.dot(layer.uB, fold_IC(layer.uB, layer.uC), precision=precision)


def reconstruct_dense_model(params: ReducedModelParams, precision=None):
    """Exact dense StackedLSTMParams from a reduced model (both sides
    reconstructed). The compressed parameterization remains the stored
    form; this is purely an execution layout.

    ``precision`` pins the reconstruction dots (the differentiable training
    view passes HIGHEST: the product IS the model's weight matrix, so an
    ambient relaxed scope must not perturb it); None uses the package
    default (f32 matmul precision, set at import)."""
    from svd_lstm_tpu.models.lstm import LSTMLayerParams, StackedLSTMParams

    layers = []
    for l in params.layers:
        if l.split:
            Wb = [
                jnp.dot(B, fold_IC(B, C), precision=precision)
                for B, C in zip(l.wB, l.wC)
            ]
            W = jnp.concatenate(Wb, axis=1)
        else:
            W = jnp.dot(l.wB, fold_IC(l.wB, l.wC), precision=precision)
        layers.append(
            LSTMLayerParams(
                W=W, U=reconstruct_recurrent_dense(l, precision), b=l.b
            )
        )
    return StackedLSTMParams(layers=tuple(layers), head=params.head)


def reduced_forward_dense_recurrent(
    params: ReducedModelParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    """Reduced-model forward with a factored x-side and a
    dense-reconstructed h-side ``lax.scan``. x_seq: (B, T, d)."""
    B, T, _ = x_seq.shape
    h = x_seq
    for layer in params.layers:
        n = layer.units
        xp = reduced_projection(layer, h, "w") + layer.b
        U = reconstruct_recurrent_dense(layer)
        xp_t = jnp.swapaxes(xp, 0, 1)

        def step(carry, xs):
            hh, cc = carry
            hh, cc = gate_update(xs + hh @ U, cc)
            return (hh, cc), hh

        (hT, _), h_seq = jax.lax.scan(
            step, (jnp.zeros((B, n), x_seq.dtype), jnp.zeros((B, n), x_seq.dtype)), xp_t
        )
        h = jnp.swapaxes(h_seq, 0, 1)
    if not return_sequences:
        h = h[:, -1]
    return h @ params.head.w + params.head.b
