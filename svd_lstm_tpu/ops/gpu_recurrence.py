"""LSTM recurrence kernel pair for narrow stacks, written in Pallas for the
Triton route.

Each program owns a tile of ``BLOCK_ROWS`` batch rows and runs the whole
time loop inside itself (``lax.fori_loop``), carrying h and c in registers;
the grid runs over batch tiles in parallel on the SMs. The recurrent matrix
is loaded once, before the loop, where it fits (``HOLD_MAX_G``). Only the
sequential ``h @ U`` product is in the kernel: the input projection
``x @ W + b`` is hoisted out as one large XLA matmul (models/lstm.py), and
so are the weight gradients.

Layout: each gate is padded to ``G = gate_width(n)`` columns (a power of
two, at least 16, which Triton's dot needs) and kept as its own column
block, so gate extraction is a static block slice of a reference, never a
slice of a value. Padded lanes and rows are inert: a zero pre-activation
keeps c and h at exactly 0 there.

* forward ``(xp, U) -> (h_seq, c_seq)``;
* backward ``(xp, U, h_seq, c_seq, dh_seq) -> dxp``, reverse time, the
  gates recomputed from ``(xp, h_prev)``, dh and dc carried across steps.
  ``dU = sum_t h_prev^T dz`` is one XLA matmul over all (T, B) rows.

Precision: ``"highest"`` lowers the in-kernel dots to IEEE f32 (the exact
mode); ``"default"`` to TF32 (the fast mode and the training default). The
package-wide ``jax_default_matmul_precision`` does not reach inside a
Triton kernel, so the precision is always passed explicitly.

The cell math is ``models.lstm.cell_update`` / ``cell_update_bwd``, the
same functions the ``lax.scan`` reference runs.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from svd_lstm_tpu.models.lstm import (
    StackedLSTMParams,
    cell_update,
    cell_update_bwd,
    stacked_lstm_apply,
)
from svd_lstm_tpu.utils.backend import interpret
from svd_lstm_tpu.utils.linalg import ceil_to, pad_gate_cols

log = logging.getLogger(__name__)

# Widest layer the kernel takes, per in-kernel precision. Measured on the
# H100 (PERF.md): IEEE f32 dots do not use the tensor cores, and at a gate
# width of 128 they run ~14x slower than the lax.scan, so the exact mode
# stops at 64 units; TF32 dots beat the scan up to 128.
MAX_UNITS = {"highest": 64, "default": 128}
BLOCK_ROWS = 16   # batch rows per program: the least M of Triton's dot
NUM_WARPS = 4
# Widest gate block whose four (G, G) weight blocks are loaded once, before
# the time loop. At G = 128 the four blocks (256 KB f32) exceed a block's
# 227 KB of shared memory once Triton stages them for its dot, so wider
# layers load each gate's block from global memory (L1/L2-resident) inside
# the step, one at a time.
HOLD_MAX_G = 64

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "default": jax.lax.Precision.DEFAULT,
}


def gate_width(n: int) -> int:
    """Columns per gate block: the next power of two >= max(n, 16)."""
    return max(16, 1 << (n - 1).bit_length())


def resolve_precision(precision: str) -> jax.lax.Precision:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown kernel precision {precision!r}; expected 'highest' or 'default'"
        )
    return _PRECISIONS[precision]


def kernel_takes(params, precision: str) -> bool:
    """Whether every layer of a stack fits the kernel at ``precision``."""
    resolve_precision(precision)
    return all(l.units <= MAX_UNITS[precision] for l in params.layers)


def _dot(a, b, prec):
    return jnp.dot(a, b, preferred_element_type=jnp.float32, precision=prec)


def _pallas(kernel, name, grid, in_specs, out_specs, out_shape):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret(),
        name=name,
    )


def _pad_state(a, Bp, G):
    """(T, B, n) -> (T, Bp, G), zero padded."""
    T, B, n = a.shape
    return jnp.pad(a, ((0, 0), (0, Bp - B), (0, G - n)))


def _pad_xp(xp, Bp, G):
    """(T, B, 4n) -> (T, Bp, 4G): each gate in its own G-column block."""
    T, B, g4 = xp.shape
    n = g4 // 4
    xp = pad_gate_cols(xp.reshape(T * B, g4), n, G).reshape(T, B, 4 * G)
    return jnp.pad(xp, ((0, 0), (0, Bp - B), (0, 0)))


def _pad_u(U, G):
    """(n, 4n) -> (G, 4G)."""
    n = U.shape[0]
    return jnp.pad(pad_gate_cols(U.astype(jnp.float32), n, G), ((0, G - n), (0, 0)))


def _gate_blocks(load, G):
    """The four per-gate weight blocks as loaders: ``blocks[g]()`` returns
    gate g's block, loaded once up front when it fits (``HOLD_MAX_G``)."""
    if G <= HOLD_MAX_G:
        held = [load(g) for g in range(4)]
        return [lambda g=g: held[g] for g in range(4)]
    return [lambda g=g: load(g) for g in range(4)]


def _fwd_kernel(xp_ref, u_ref, h_ref, c_ref, *, T, G, prec):
    U = _gate_blocks(lambda g: u_ref[:, g * G:(g + 1) * G], G)

    def step(t, hc):
        h, c = hc
        z = [xp_ref[t, :, g * G:(g + 1) * G] + _dot(h, U[g](), prec) for g in range(4)]
        h, c = cell_update(*z, c)
        h_ref[t] = h
        c_ref[t] = c
        return h, c

    zero = jnp.zeros((BLOCK_ROWS, G), jnp.float32)
    jax.lax.fori_loop(0, T, step, (zero, zero))


def forward_padded(xp_p, u_p, precision: str):
    """Forward kernel on padded operands: xp_p (T, Bp, 4G), u_p (G, 4G) ->
    (h_seq, c_seq), each (T, Bp, G)."""
    T, Bp, G4 = xp_p.shape
    G = G4 // 4
    kernel = functools.partial(_fwd_kernel, T=T, G=G, prec=resolve_precision(precision))
    state = pl.BlockSpec((T, BLOCK_ROWS, G), lambda i: (0, i, 0))
    return _pallas(
        kernel, "lstm_recurrence_fwd", (Bp // BLOCK_ROWS,),
        [pl.BlockSpec((T, BLOCK_ROWS, G4), lambda i: (0, i, 0)),
         pl.BlockSpec((G, G4), lambda i: (0, 0))],
        [state, state],
        [jax.ShapeDtypeStruct((T, Bp, G), jnp.float32)] * 2,
    )(xp_p, u_p)


def _bwd_kernel(xp_ref, u_ref, ut_ref, h_ref, c_ref, dh_ref, dxp_ref, *, T, G, prec):
    U = _gate_blocks(lambda g: u_ref[:, g * G:(g + 1) * G], G)
    UT = _gate_blocks(lambda g: ut_ref[g * G:(g + 1) * G, :], G)

    def step(k, carry):
        dh_rec, dc = carry
        t = T - 1 - k
        tp = jnp.maximum(t - 1, 0)
        live = t > 0  # at t = 0 the previous state is the zero initial state
        hp = jnp.where(live, h_ref[tp], 0.0)
        cp = jnp.where(live, c_ref[tp], 0.0)
        z = [xp_ref[t, :, g * G:(g + 1) * G] + _dot(hp, U[g](), prec) for g in range(4)]
        dz, dc = cell_update_bwd(*z, cp, c_ref[t], dh_ref[t] + dh_rec, dc)
        dh_rec = _dot(dz[0], UT[0](), prec)
        for g in range(4):
            dxp_ref[t, :, g * G:(g + 1) * G] = dz[g]
            if g:
                dh_rec = dh_rec + _dot(dz[g], UT[g](), prec)
        return dh_rec, dc

    zero = jnp.zeros((BLOCK_ROWS, G), jnp.float32)
    jax.lax.fori_loop(0, T, step, (zero, zero))


def backward_padded(xp_p, u_p, h_p, c_p, dh_p, precision: str):
    """Backward kernel on padded operands -> dxp_p (T, Bp, 4G)."""
    T, Bp, G4 = xp_p.shape
    G = G4 // 4
    kernel = functools.partial(_bwd_kernel, T=T, G=G, prec=resolve_precision(precision))
    state = pl.BlockSpec((T, BLOCK_ROWS, G), lambda i: (0, i, 0))
    gates = pl.BlockSpec((T, BLOCK_ROWS, G4), lambda i: (0, i, 0))
    return _pallas(
        kernel, "lstm_recurrence_bwd", (Bp // BLOCK_ROWS,),
        [gates, pl.BlockSpec((G, G4), lambda i: (0, 0)),
         pl.BlockSpec((G4, G), lambda i: (0, 0)), state, state, state],
        gates,
        jax.ShapeDtypeStruct((T, Bp, G4), jnp.float32),
    )(xp_p, u_p, u_p.T, h_p, c_p, dh_p)


def lstm_recurrence_fwd(xp, U, precision: str = "highest"):
    """xp (T, B, 4n) time-major, bias included; U (n, 4n) ->
    (h_seq, c_seq), each (T, B, n)."""
    T, B, g4 = xp.shape
    n = g4 // 4
    G = gate_width(n)
    Bp = ceil_to(B, BLOCK_ROWS)
    h, c = forward_padded(_pad_xp(xp.astype(jnp.float32), Bp, G), _pad_u(U, G), precision)
    return h[:, :B, :n], c[:, :B, :n]


def lstm_recurrence_bwd(xp, U, h_seq, c_seq, dh_seq, precision: str = "highest"):
    """Cotangents ``(dxp, dU)`` of :func:`lstm_recurrence_fwd`'s h_seq."""
    T, B, g4 = xp.shape
    n = g4 // 4
    G = gate_width(n)
    Bp = ceil_to(B, BLOCK_ROWS)
    dxp = backward_padded(
        _pad_xp(xp.astype(jnp.float32), Bp, G), _pad_u(U, G),
        _pad_state(h_seq, Bp, G), _pad_state(c_seq, Bp, G),
        _pad_state(dh_seq.astype(jnp.float32), Bp, G), precision,
    )
    dxp = dxp[:, :B].reshape(T, B, 4, G)[..., :n].reshape(T, B, g4)
    h_prev = jnp.concatenate([jnp.zeros_like(h_seq[:1]), h_seq[:-1]], axis=0)
    dU = jnp.einsum("tbn,tbg->ng", h_prev, dxp, precision=resolve_precision(precision))
    return dxp, dU.astype(U.dtype)


@functools.lru_cache(maxsize=None)
def _trainable(precision: str):
    @jax.custom_vjp
    def rec(xp, U):
        return lstm_recurrence_fwd(xp, U, precision)[0]

    def fwd(xp, U):
        h, c = lstm_recurrence_fwd(xp, U, precision)
        return h, (xp, U, h, c)

    def bwd(res, dh):
        xp, U, h, c = res
        dxp, dU = lstm_recurrence_bwd(xp, U, h, c, dh, precision)
        return dxp.astype(xp.dtype), dU

    rec.defvjp(fwd, bwd)
    return rec


def lstm_recurrence(xp, U, precision: str = "highest"):
    """Differentiable kernel recurrence: xp (T, B, 4n) -> h_seq (T, B, n)."""
    return _trainable(precision)(xp, U)


def _stack(params: StackedLSTMParams, x_seq, return_sequences, precision, xprec):
    h = jnp.swapaxes(x_seq, 0, 1)  # (T, B, d)
    for l in params.layers:
        xp = jnp.einsum("tbd,dg->tbg", h, l.W, precision=xprec) + l.b
        h = lstm_recurrence(xp, l.U, precision)
    if not return_sequences:
        return h[-1] @ params.head.w + params.head.b
    return jnp.swapaxes(h @ params.head.w + params.head.b, 0, 1)


@functools.partial(jax.jit, static_argnames=("precision",))
def stack_forward(params: StackedLSTMParams, x, precision: str = "highest"):
    """Whole-run inference of a narrow dense stack through the forward
    kernel. x (T, d) -> (T, out), or (B, T, d) -> (B, T, out).
    ``precision`` sets the in-kernel dots and the hoisted x-side matmul."""
    if not kernel_takes(params, precision):
        raise ValueError(
            f"the recurrence kernel takes layers of at most "
            f"{MAX_UNITS[precision]} units at precision {precision!r} "
            f"(got {max(l.units for l in params.layers)})"
        )
    prec = resolve_precision(precision)
    xb = x if x.ndim == 3 else x[None]
    out = _stack(params, xb.astype(jnp.float32), True, precision, prec)
    return out if x.ndim == 3 else out[0]


def stacked_lstm_apply_fast_train(
    params: StackedLSTMParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
    precision: str = "default",
) -> jax.Array:
    """Drop-in training ``apply_fn`` (x_seq (B, T, d)) running each layer's
    recurrence through the kernel pair; the hoisted projections follow the
    ambient matmul precision (``TrainConfig.matmul_precision``). Wide stacks
    take the ``lax.scan`` (XLA hands their per-step product to cuBLAS)."""
    if not kernel_takes(params, precision):
        log.warning(
            "recurrence_kernel: layers wider than %d units train on the "
            "lax.scan path", MAX_UNITS[precision],
        )
        return stacked_lstm_apply(params, x_seq, return_sequences)
    return _stack(params, x_seq, return_sequences, precision, None)
