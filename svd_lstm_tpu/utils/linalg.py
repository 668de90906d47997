"""Shared padding / folding helpers used by model applies and kernels."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def zeros_varying_like(ref, shape, dtype) -> jax.Array:
    """``jnp.zeros(shape, dtype)`` carrying the same varying-manual-axes
    (vma) type as ``ref``.

    Inside a ``shard_map(..., check_vma=True)`` region, a scan whose
    outputs depend on sharded inputs must start from a carry that is
    *typed* as varying over the same mesh axes — a plain ``jnp.zeros`` is
    unvarying and fails the static check. Outside shard_map (or with the
    check off) this is exactly ``jnp.zeros``.
    """
    z = jnp.zeros(shape, dtype)
    vma = getattr(getattr(ref, "aval", None), "vma", None)
    if vma:
        z = jax.lax.pcast(z, tuple(vma), to="varying")
    return z


def pad_rows(M: jax.Array, rows: int) -> jax.Array:
    out = jnp.zeros((rows, M.shape[1]), M.dtype)
    return out.at[: M.shape[0]].set(M)


def pad_cols(M: jax.Array, cols: int) -> jax.Array:
    out = jnp.zeros((M.shape[0], cols), M.dtype)
    return out.at[:, : M.shape[1]].set(M)


def pad_gate_cols(M: jax.Array, n: int, npg: int) -> jax.Array:
    """(rows, 4n) -> (rows, 4*npg), gate g at columns [g*npg, g*npg+n)."""
    rows = M.shape[0]
    out = jnp.zeros((rows, 4 * npg), M.dtype)
    for g in range(4):
        out = out.at[:, g * npg : g * npg + n].set(M[:, g * n : (g + 1) * n])
    return out


def fold_IC(B: jax.Array, C: jax.Array) -> jax.Array:
    """[I | C]: (r, r + C.cols). (x@B) @ [I|C] == concat(x@B, (x@B)@C) —
    the folded form of the exact two-step product (no concatenation)."""
    r = B.shape[1]
    eye = jnp.eye(r, dtype=B.dtype)
    return jnp.concatenate([eye, C], axis=1) if C.shape[1] else eye
