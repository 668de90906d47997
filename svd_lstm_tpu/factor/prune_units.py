"""Structural unit pruning — compression beyond the reference.

The reference compresses matrix *rank*; at batch-1 the per-step chain is
latency-bound, and rank alone cannot cut its floor. Removing whole hidden units
does: every weight matrix physically shrinks, so the streamed bytes and
the state width drop together. This composes with SVD truncation (prune
units first, then factorize/truncate the smaller model).

Removing unit k of layer l means dropping, consistently:
* layer l: column k of every W gate block and U gate block, row k of U,
  bias entry k in every gate segment;
* layer l+1 (or the dense head): input row k.

``unit_importance`` scores each unit by the L2 norm of everything it
produces (its recurrent output row and its contribution to the next
layer) scaled by what it receives — the standard magnitude heuristic.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import (
    DenseParams,
    LSTMLayerParams,
    StackedLSTMParams,
)


def _gate_cols(M: np.ndarray, n: int, keep: np.ndarray) -> np.ndarray:
    """Keep columns `keep` of each gate block of (rows, 4n)."""
    return np.concatenate(
        [M[:, g * n : (g + 1) * n][:, keep] for g in range(4)], axis=1
    )


def unit_importance(params: StackedLSTMParams) -> list:
    """Per-layer importance scores, shape (units,) each."""
    scores = []
    for li, layer in enumerate(params.layers):
        n = layer.units
        W = np.asarray(layer.W)
        U = np.asarray(layer.U)
        # inbound: how strongly the unit's gates are driven
        inbound = np.zeros(n)
        for g in range(4):
            inbound += np.linalg.norm(W[:, g * n : (g + 1) * n], axis=0) ** 2
            inbound += np.linalg.norm(U[:, g * n : (g + 1) * n], axis=0) ** 2
        # outbound: how strongly the unit's h feeds the rest of the network
        out_mat = (
            np.asarray(params.layers[li + 1].W)
            if li + 1 < len(params.layers)
            else np.asarray(params.head.w)
        )
        outbound = np.linalg.norm(out_mat, axis=1) ** 2
        outbound = outbound + np.linalg.norm(U, axis=1) ** 2  # recurrent reuse
        scores.append(np.sqrt(inbound) * np.sqrt(outbound))
    return scores


def prune_units(
    params: StackedLSTMParams, keep: Sequence[np.ndarray]
) -> StackedLSTMParams:
    """Keep only the listed unit indices per layer (sorted ascending).

    ``keep[l]`` is an index array into layer l's units. Exact: the pruned
    model computes what the original would with those units' states forced
    to zero."""
    keep = [np.sort(np.asarray(k)) for k in keep]
    layers = []
    for li, layer in enumerate(params.layers):
        n = layer.units
        k = keep[li]
        W = np.asarray(layer.W)
        U = np.asarray(layer.U)
        b = np.asarray(layer.b)
        if li > 0:
            W = W[keep[li - 1]]              # previous layer's surviving outputs
        U = U[k]                             # surviving state rows
        W = _gate_cols(W, n, k)
        U = _gate_cols(U, n, k)
        b = np.concatenate([b[g * n : (g + 1) * n][k] for g in range(4)])
        layers.append(
            LSTMLayerParams(W=jnp.asarray(W), U=jnp.asarray(U), b=jnp.asarray(b))
        )
    head_w = np.asarray(params.head.w)[keep[-1]]
    head = DenseParams(w=jnp.asarray(head_w), b=params.head.b)
    return StackedLSTMParams(layers=tuple(layers), head=head)


def prune_to_width(
    params: StackedLSTMParams, widths: Sequence[int]
) -> StackedLSTMParams:
    """Keep the ``widths[l]`` most important units of each layer."""
    scores = unit_importance(params)
    keep = [np.argsort(s)[::-1][: w].copy() for s, w in zip(scores, widths)]
    return prune_units(params, keep)
