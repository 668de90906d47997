"""Pipeline-parallel whole-run inference: layer stages over a ``pp`` mesh axis.

The one scaling regime dp cannot touch is the reference's own headline
benchmark — batch-1 inference over ONE long run (T ≈ 10⁴–10⁵ DROPBEAR
frames, reference code/svd_acceleration_v3.py:147-152): there are no
independent sequences to shard, and the recurrence is sequential in time.
Pipeline parallelism fits it exactly, because a stacked LSTM is a chain of
per-layer recurrences that are sequential in *time* but independent across
*layers* once the upstream hidden sequence is known:

* the time axis is cut into chunks of ``ct`` steps;
* stage ``s`` of the ``pp`` axis owns layers ``[s·L/S, (s+1)·L/S)`` and
  their recurrent state, which never leaves the device;
* at wavefront tick ``k``, stage ``s`` runs its layers over chunk
  ``k − s`` and hands the resulting hidden chunk to stage ``s+1`` over
  the device interconnect via ``lax.ppermute`` — the classic GPipe-style schedule, except no
  microbatching is needed: the recurrent state makes chunk ``c`` depend on
  chunk ``c−1`` *within* a stage, which the wavefront satisfies for free.

Steady-state efficiency is ``C / (C + S − 1)`` for ``C = T/ct`` chunks
(> 92% at the headline T=6656 with ct=512, S=4), and the per-tick
transfer — one (B, ct, n) block, amortized over ``ct·L/S`` dependent
recurrence steps — rides a single ppermute hop. The reference, a
single-process Keras interpreter, has no analog (SURVEY.md §2: "no
parallelism strategy of any kind").

Both model families the benchmark compares run under the same wavefront:

* **dense** (``StackedLSTMParams``) — stages carry stacked (n, 4n)
  kernels;
* **reduced** (``ReducedModelParams``, the compressed family) — each
  layer's exact two-step product is folded to ``(x @ P1) @ P2`` with
  ``P2 = [I | C]`` (merged) or a block-diagonal per-gate arrangement
  (split), rank-padded with zero columns/rows so every layer stacks to
  uniform (n, R)/(R, 4n) blocks — all exact, the same identities
  ``models/reduced.reduced_projection`` uses. For narrow models where the
  two-step does not pay, reconstruct first: ``make_pipeline_inference``'s
  wavefront is family-agnostic, so
  ``ops.layouts.reconstruct_dense_model(reduced)`` feeds the dense path.

Exactness of the input pad: layer 1's (d, 4n) kernel (or (d, R) first
factor) is zero-row-padded to width n and the input zero-padded to width
n so every stage runs the same stacked shapes — extra columns of x meet
zero rows of the kernel, contributing exactly nothing.

Training deliberately does NOT go through pp: the training workload is
windowed BPTT over thousands of independent windows (SURVEY.md §5), where
dp sharding is bubble-free and collective-light (one grad psum per step),
strictly dominating a wavefront's fill/drain bubbles and per-tick
activation + cotangent transfers for these layer sizes. pp exists for the
workload that has no batch axis to shard — deployment-shaped whole-run
inference.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svd_lstm_tpu.models.lstm import StackedLSTMParams, gate_update
from svd_lstm_tpu.models.reduced import ReducedModelParams
from svd_lstm_tpu.utils.linalg import (
    fold_IC,
    pad_cols,
    pad_rows,
    zeros_varying_like,
)


def _check_uniform(units, n_stages: int, d: int):
    L = len(units)
    n = units[0]
    if any(u != n for u in units):
        raise ValueError(
            f"pipeline stages need uniform units, got {list(units)}; "
            "non-uniform stacks shard over dp instead (parallel/train.py)"
        )
    if L % n_stages != 0:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    if d > n:
        raise ValueError(
            f"input_dim {d} > units {n}: layer-1 padding cannot stack"
        )
    return L, n


def _pack_stages(params: StackedLSTMParams, n_stages: int):
    """Stack uniform layers into (S, Lps, n, 4n)/(S, Lps, 4n) stage blocks.

    Requires uniform units and L % n_stages == 0; layer 1's W is
    zero-row-padded from (d, 4n) to (n, 4n) (exact — see module docstring).
    """
    d = params.layers[0].W.shape[0]
    L, n = _check_uniform([l.units for l in params.layers], n_stages, d)
    W1 = params.layers[0].W
    if d < n:
        W1 = jnp.concatenate([W1, jnp.zeros((n - d, 4 * n), W1.dtype)], axis=0)
    Ws = jnp.stack([W1] + [l.W for l in params.layers[1:]])
    Us = jnp.stack([l.U for l in params.layers])
    bs = jnp.stack([l.b for l in params.layers])
    lps = L // n_stages
    return (
        Ws.reshape(n_stages, lps, n, 4 * n),
        Us.reshape(n_stages, lps, n, 4 * n),
        bs.reshape(n_stages, lps, 4 * n),
    )


def _fold_side(Bs, Cs, n: int):
    """One layer side's two-step → folded (m, R)/(R, 4n) factor pair.

    merged: P1 = B, P2 = [I | C] (models/reduced.py:95). split: gate g's
    padded B occupies P1 columns [g·r, (g+1)·r) and its padded [I|C] the
    matching P2 rows against output columns [g·n, (g+1)·n) — block-diagonal,
    so x @ P1 @ P2 == concat_g(two_step(x, B_g, C_g)) exactly.
    """
    if not isinstance(Bs, tuple):
        return Bs, fold_IC(Bs, Cs)
    r = max(B.shape[1] for B in Bs)
    P1 = jnp.concatenate([pad_cols(B, r) for B in Bs], axis=1)
    P2 = jnp.zeros((4 * r, 4 * n), Bs[0].dtype)
    for g, (B, C) in enumerate(zip(Bs, Cs)):
        blk = pad_rows(fold_IC(B, C), r)
        P2 = P2.at[g * r : (g + 1) * r, g * n : (g + 1) * n].set(blk)
    return P1, P2


def _pack_stages_reduced(params: ReducedModelParams, n_stages: int):
    """Fold every layer's two-step products and stack into stage blocks
    (S, Lps, n, Rw), (S, Lps, Rw, 4n), (S, Lps, n, Ru), (S, Lps, Ru, 4n),
    (S, Lps, 4n) — rank-padding across layers is exact (zero columns of P1
    meet zero rows of P2)."""
    layers = params.layers
    d = (layers[0].wB[0] if layers[0].split else layers[0].wB).shape[0]
    L, n = _check_uniform([l.units for l in layers], n_stages, d)
    folded = [
        (_fold_side(l.wB, l.wC, n), _fold_side(l.uB, l.uC, n)) for l in layers
    ]
    Rw = max(w1.shape[1] for (w1, _), _ in folded)
    Ru = max(u1.shape[1] for _, (u1, _) in folded)

    def pad_pair(P1, P2, m: int, R: int):
        P1 = pad_cols(P1, R)
        if P1.shape[0] < m:
            P1 = pad_rows(P1, m)
        return P1, pad_rows(P2, R)

    W1s, W2s, U1s, U2s = [], [], [], []
    for i, ((w1, w2), (u1, u2)) in enumerate(folded):
        w1, w2 = pad_pair(w1, w2, n if i == 0 else w1.shape[0], Rw)
        u1, u2 = pad_pair(u1, u2, n, Ru)
        W1s.append(w1), W2s.append(w2), U1s.append(u1), U2s.append(u2)
    bs = jnp.stack([l.b for l in layers])
    lps = L // n_stages
    return (
        jnp.stack(W1s).reshape(n_stages, lps, n, Rw),
        jnp.stack(W2s).reshape(n_stages, lps, Rw, 4 * n),
        jnp.stack(U1s).reshape(n_stages, lps, n, Ru),
        jnp.stack(U2s).reshape(n_stages, lps, Ru, 4 * n),
        bs.reshape(n_stages, lps, 4 * n),
    )


def _dense_layer_math(w):
    Wl, Ul, bl = w

    def xp(j, cur):
        return jnp.einsum("btn,ng->btg", cur, Wl[j]) + bl[j]

    def rec(j, h):
        return h @ Ul[j]

    return xp, rec, Wl.shape[0]


def _reduced_layer_math(w):
    W1, W2, U1, U2, bl = w

    def xp(j, cur):
        return jnp.einsum("btr,rg->btg", jnp.einsum("btn,nr->btr", cur, W1[j]), W2[j]) + bl[j]

    def rec(j, h):
        return (h @ U1[j]) @ U2[j]

    return xp, rec, W1.shape[0]


def make_pipeline_inference(
    mesh: Mesh,
    n_stages: int | None = None,
    ct: int = 512,
    return_sequences: bool = True,
) -> Callable:
    """Build a jitted pipeline-parallel forward pass over ``mesh``'s devices.

    Returns ``run(params, X) -> (B, T, 1)`` predictions (or ``(B, 1)`` when
    ``return_sequences=False``) numerically equal to
    ``stacked_lstm_apply`` / ``reduced_lstm_apply`` for
    ``StackedLSTMParams`` / ``ReducedModelParams`` respectively — tested on
    the virtual CPU mesh (tests/test_pipeline.py). ``n_stages`` defaults to
    every device of the mesh; the model's layer count must be divisible by
    it.
    """
    n_dev = mesh.devices.size
    S = n_dev if n_stages is None else n_stages
    if S > n_dev:
        raise ValueError(f"n_stages {S} exceeds {n_dev} devices")
    pp_mesh = Mesh(mesh.devices.reshape(-1)[:S], ("pp",))

    def local_stage(w, x, C: int, make_math):
        """One pp shard: ``w`` stage weights with a leading (1, Lps, ...)
        shard axis, x (B, C·ct, n) replicated. Returns the last layer's
        hidden sequence, replicated via a masked psum."""
        w = tuple(a[0] for a in w)
        layer_xp, layer_rec, lps = make_math(w)
        B, Tpad, n = x.shape
        s = jax.lax.axis_index("pp")
        is_first = s == 0
        is_last = s == S - 1

        def run_chunk(h, c, inp):
            """My lps layers over one (B, ct, n) chunk; states (lps, B, n)."""
            new_h, new_c = [], []
            cur = inp
            for j in range(lps):
                xp = layer_xp(j, cur)

                def step(carry, xp_t):
                    hh, cc = carry
                    hh, cc = gate_update(xp_t + layer_rec(j, hh), cc)
                    return (hh, cc), hh

                (hj, cj), h_seq = jax.lax.scan(
                    step, (h[j], c[j]), jnp.swapaxes(xp, 0, 1)
                )
                cur = jnp.swapaxes(h_seq, 0, 1)
                new_h.append(hj)
                new_c.append(cj)
            return jnp.stack(new_h), jnp.stack(new_c), cur

        def tick(k, carry):
            buf, h, c, out = carry
            ci = k - s  # my chunk index this tick
            active = (ci >= 0) & (ci < C)
            cidx = jnp.clip(ci, 0, C - 1)
            x_chunk = jax.lax.dynamic_slice(
                x, (0, cidx * ct, 0), (B, ct, n)
            )
            inp = jnp.where(is_first, x_chunk, buf)
            h2, c2, chunk_out = run_chunk(h, c, inp)
            # inactive ticks (pipeline fill/drain) must not advance state
            h = jnp.where(active, h2, h)
            c = jnp.where(active, c2, c)
            # the final stage lands its chunk in the output buffer
            keep = jax.lax.dynamic_slice(out, (0, cidx * ct, 0), (B, ct, n))
            write = jnp.where(active & is_last, chunk_out, keep)
            out = jax.lax.dynamic_update_slice(out, write, (0, cidx * ct, 0))
            # hand my chunk downstream; stage S-1's send drops off the edge
            # (ppermute delivers zeros where no source maps), stage 0 never
            # reads buf
            buf = jax.lax.ppermute(
                chunk_out, "pp", [(i, i + 1) for i in range(S - 1)]
            )
            return buf, h, c, out

        init = (
            zeros_varying_like(w[0], (B, ct, n), x.dtype),  # vma: varies like W
            zeros_varying_like(w[0], (lps, B, n), x.dtype),
            zeros_varying_like(w[0], (lps, B, n), x.dtype),
            zeros_varying_like(w[0], (B, Tpad, n), x.dtype),
        )
        _, _, _, out = jax.lax.fori_loop(0, C + S - 1, tick, init)
        # replicate the last stage's output to every device
        return jax.lax.psum(jnp.where(is_last, out, jnp.zeros_like(out)), "pp")

    @jax.jit
    def _run(params, X):
        B, T, d = X.shape
        if isinstance(params, ReducedModelParams):
            w = _pack_stages_reduced(params, S)
            make_math = _reduced_layer_math
        else:
            w = _pack_stages(params, S)
            make_math = _dense_layer_math
        n = w[0].shape[2]
        C = -(-T // ct)
        Tpad = C * ct
        Xp = jnp.zeros((B, Tpad, n), X.dtype)
        Xp = Xp.at[:, :T, :d].set(X)
        w = tuple(
            jax.device_put(a, NamedSharding(pp_mesh, P("pp"))) for a in w
        )
        Xp = jax.device_put(Xp, NamedSharding(pp_mesh, P()))
        out = shard_map(
            lambda wt, x: local_stage(wt, x, C, make_math),
            mesh=pp_mesh,
            in_specs=(P("pp"), P()),
            out_specs=P(),
            check_vma=True,
        )(w, Xp)
        h_last = out[:, :T]
        if return_sequences:
            return h_last @ params.head.w + params.head.b
        return h_last[:, -1] @ params.head.w + params.head.b

    def run(params, X):
        # normalize onto the pp sub-mesh first: params that arrive committed
        # to a different device set (e.g. the full dp mesh a fit_dp /
        # finetune_dp run left them on) would otherwise clash with the
        # device_puts the traced body issues
        rep = NamedSharding(pp_mesh, P())
        params = jax.device_put(params, rep)
        return _run(params, jax.device_put(jnp.asarray(X), rep))

    return run
