"""Rank-truncated ("reduced") LSTM layer — the exact two-step cell.

After dropping singular values below a cutoff, each rank-r factor triple is
re-expressed as the exact two-step product (reference
code/svd_classes_v3.py:604-676; derivation in slides 6-9):

    B = (U·Σ) @ V₁          (m × r)
    C = V₁⁻¹ @ V₂           (r × (n − r))
    x @ W  ==  concat(x @ B, (x @ B) @ C)      -- exact while Σ is unmasked

costing r·m + r·(n−r) MACs instead of m·n (slide 9's weight-count formula).

* merged kernel: one (B, C) pair for the whole (d × 4n) kernel and one for
  the (n × 4n) recurrent kernel (reference ReducedLSTMCell merged path,
  code/svd_classes_v3.py:249-279,317-328);
* split kernel: per-gate (B, C) pairs with *per-gate ranks* — stored as
  tuples because ranks differ (reference :281-315,330-363).

The input-side two-step is hoisted out of the recurrence for the whole
sequence; the scan carries only the hidden-state two-step. All weights are
inference-time constants.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import DenseParams, gate_update
from svd_lstm_tpu.utils.linalg import zeros_varying_like


class ReducedLayerParams(NamedTuple):
    # merged: wB (d, rw), wC (rw, 4n-rw) — single arrays
    # split:  tuples of 4 arrays, gate order [i, f, c, o]:
    #         wB[g] (d, r_g), wC[g] (r_g, n - r_g)
    wB: jax.Array | Tuple[jax.Array, ...]
    wC: jax.Array | Tuple[jax.Array, ...]
    uB: jax.Array | Tuple[jax.Array, ...]
    uC: jax.Array | Tuple[jax.Array, ...]
    b: jax.Array  # (4n,)

    @property
    def split(self) -> bool:
        return isinstance(self.wB, tuple)

    @property
    def units(self) -> int:
        if self.split:
            return self.uB[0].shape[0]
        return self.uB.shape[0]

    @property
    def input_dim(self) -> int:
        if self.split:
            return self.wB[0].shape[0]
        return self.wB.shape[0]

    def weight_count(self) -> int:
        """Stored-weight count — the metric the reference reports
        (code/svd_acceleration_v3.py:160-170)."""
        leaves = jax.tree_util.tree_leaves(self)
        return int(sum(x.size for x in leaves))


class ReducedModelParams(NamedTuple):
    layers: Tuple[ReducedLayerParams, ...]
    head: DenseParams


def two_step(x: jax.Array, B: jax.Array, C: jax.Array) -> jax.Array:
    """concat(x @ B, (x @ B) @ C) along the last axis — exact low-rank apply."""
    xb = x @ B
    return jnp.concatenate([xb, xb @ C], axis=-1)


def pack_split_projection(Bs, Cs) -> Tuple[jax.Array, jax.Array]:
    """Rank-pad and stack a split side's per-gate factors for the batched
    two-einsum form: (Bp (4, d, rmax), ICp (4, rmax, n)). Zero pad
    columns/rows keep the product exact. ONE packing rule — shared by
    ``reduced_projection`` and the streaming step
    (models/streaming.py), so a layout change cannot fix one and miss the
    other."""
    from svd_lstm_tpu.utils.linalg import fold_IC, pad_cols, pad_rows

    rmax = max(B.shape[1] for B in Bs)
    Bp = jnp.stack([pad_cols(B, rmax) for B in Bs])               # (4, d, rmax)
    ICp = jnp.stack(
        [pad_rows(fold_IC(B, C), rmax) for B, C in zip(Bs, Cs)]
    )                                                              # (4, rmax, n)
    return Bp, ICp


def apply_split_projection(x, Bp, ICp) -> jax.Array:
    """The batched split two-step: per gate (x @ B) @ [I|C], all four gates
    in two einsums, gate blocks concatenated -> (..., 4n)."""
    xb = jnp.einsum("...d,gdr->...gr", x, Bp)
    z = jnp.einsum("...gr,grn->...gn", xb, ICp)
    return z.reshape(*z.shape[:-2], -1)


def reduced_projection(p: ReducedLayerParams, x, which: str) -> jax.Array:
    """Two-step product for input ('w') or recurrent ('u') side -> (..., 4n).

    Executed in the folded form ``(x @ B) @ [I|C]`` (identical values, no
    concatenation); split-mode gates are rank-padded with zero columns/rows
    (exact) and stacked so the whole 4-gate product is two batched einsums,
    with no per-gate intermediates to materialize.
    """
    from svd_lstm_tpu.utils.linalg import fold_IC

    Bs = p.wB if which == "w" else p.uB
    Cs = p.wC if which == "w" else p.uC
    if p.split:
        return apply_split_projection(x, *pack_split_projection(Bs, Cs))
    return (x @ Bs) @ fold_IC(Bs, Cs)


def reduced_layer_apply(
    p: ReducedLayerParams,
    x_seq: jax.Array,
    h0: jax.Array | None = None,
    c0: jax.Array | None = None,
    return_state: bool = False,
):
    B_, T, _ = x_seq.shape
    n = p.units
    dtype = x_seq.dtype
    if h0 is None:
        h0 = zeros_varying_like(x_seq, (B_, n), dtype)
    if c0 is None:
        c0 = zeros_varying_like(x_seq, (B_, n), dtype)

    xp = reduced_projection(p, x_seq, "w") + p.b
    xp_t = jnp.swapaxes(xp, 0, 1)

    def step(carry, xp_step):
        h, c = carry
        z = xp_step + reduced_projection(p, h, "u")
        h, c = gate_update(z, c)
        return (h, c), h

    (hT, cT), h_seq = jax.lax.scan(step, (h0, c0), xp_t)
    h_seq = jnp.swapaxes(h_seq, 0, 1)
    if return_state:
        return h_seq, (hT, cT)
    return h_seq


def reduced_lstm_apply(
    params: ReducedModelParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
) -> jax.Array:
    h = x_seq
    for layer in params.layers:
        h = reduced_layer_apply(layer, h)
    if not return_sequences:
        h = h[:, -1]
    return h @ params.head.w + params.head.b
