"""Precision casting for inference.

bfloat16 weights halve memory traffic and run on the GPU's tensor cores —
a mode for throughput-bound wide-model inference. Gate math stays in
f32 (XLA accumulates bf16 matmuls in f32 by default). The framework default
remains full f32 for exact-reconstruction parity with the reference.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

# Named inference precision modes (errors and times on the H100: PERF.md):
# 'exact' = IEEE f32 matmuls (package default), 'high' = TF32 matmuls on
# the tensor cores (10 mantissa bits), 'fast' = bf16 params + activations.
PRECISION_MODES = ("exact", "high", "fast")


def matmul_scope(precision: str):
    """Context manager selecting the matmul passes for a named precision
    mode. 'high' relaxes to TF32; 'exact' and 'fast' are no-op scopes
    ('fast' gets its speed from bf16-cast operands, see :func:`cast_params`)."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "high":
        return jax.default_matmul_precision("tensorfloat32")
    return contextlib.nullcontext()


def cast_params(params, dtype=jnp.bfloat16):
    """Cast every floating leaf of a parameter pytree."""
    def cast(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, params)
