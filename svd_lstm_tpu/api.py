"""High-level inference API: ``predict(params, x)``.

Dispatch (times on the H100 are in PERF.md):

* batch-1 on the GPU, every layer narrow enough for the kernel (n <= 64
  exact, n <= 128 fast): the Pallas recurrence kernel
  (ops/gpu_recurrence.py) for the dense, singular and reduced families —
  the factored families through their exact dense reconstruction;
* everything else: XLA (``lax.scan`` with hoisted input projections).

``impl="fused"`` names the kernel explicitly (it also runs on the CPU, in
interpret mode); ``impl="scan"`` names XLA.

Precision modes:

* ``"exact"`` (default): f32 matmuls, and IEEE f32 dots inside the kernel;
* ``"high"``: TF32 matmuls (``jax.default_matmul_precision
  ("tensorfloat32")``), batched input only (batch-1 runs exact);
* ``"fast"``: batched input runs the bf16 XLA scan; batch-1 runs the kernel
  with TF32 dots. The errors of each mode against exact, measured on the
  card, are in PERF.md.
"""

from __future__ import annotations

from svd_lstm_tpu.models.lstm import StackedLSTMParams, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import ReducedModelParams
from svd_lstm_tpu.models.singular import SingularModelParams, singular_lstm_apply
from svd_lstm_tpu.utils.backend import platform

IMPLS = ("auto", "scan", "fused")


def model_input_dim(params) -> int:
    """Frame width the model consumes: the conv front end's channel count
    for the conv hybrids, else layer 0's ``input_dim`` (every LSTM layer
    type exposes it). The one place CLI/tooling should derive probe-input
    widths from."""
    if hasattr(params, "conv"):
        return int(params.conv.w.shape[1])
    return int(params.layers[0].input_dim)


def _max_units(params) -> int:
    return max(l.units for l in params.layers)


def valid_impls(params, x, precision: str = "exact") -> list:
    """Implementations with *distinct execution paths* for this (model,
    input, precision) — the candidate set ``bench.autotune`` measures.

    Lives next to the dispatch in :func:`predict` so the two cannot drift:
    'auto' always resolves to one of the listed impls, and 'fused' is
    listed only for batch-1 input whose layers the kernel takes at this
    precision (ops.gpu_recurrence.MAX_UNITS).
    """
    if x.ndim == 3:
        return ["scan"]
    if hasattr(params, "inner"):  # conv hybrids route on the inner stack
        params = params.inner
    from svd_lstm_tpu.ops.gpu_recurrence import kernel_takes

    if kernel_takes(params, _kernel_precision(precision)):
        return ["scan", "fused"]
    return ["scan"]


def _kernel_precision(precision: str) -> str:
    """The kernel's dot precision for a predict mode: TF32 for 'fast', IEEE
    f32 otherwise (batch-1 'high' runs exact)."""
    return "default" if precision == "fast" else "highest"


def predict(params, x, impl: str = "auto", precision: str = "exact",
            consult_cache: bool = True):
    """Whole-run inference.

    x: (T, d) for batch-1 or (B, T, d) batched. Returns (T, out) / (B, T, out).
    impl: 'auto' | 'scan' | 'fused' (the recurrence kernel, batch-1 only).
    precision: 'exact' | 'high' | 'fast' (module docstring). Batch-1 'fast'
    reaches only the kernel: with impl='scan' (or off the GPU under
    impl='auto') the exact f32 scan runs, matching the batched
    impl='scan' escape hatch's exact semantics rather than silently
    changing numerics.

    impl='auto' first consults the persistent autotune cache
    (``bench.autotune.cached_impl``, device-kind-keyed): if this exact
    (model, input, precision) was ever measured on this device (``python
    -m svd_lstm_tpu tune`` or ``tuned_impl``), the measured winner
    dispatches; otherwise the rule in the module docstring applies. Stale
    entries that are no longer valid for the input are ignored.
    ``consult_cache=False`` bypasses the lookup (``bench.autotune.autotune``
    measures with it off so a pre-existing entry cannot redirect the
    'auto' candidate mid-measure).
    """
    from svd_lstm_tpu.utils.precision import cast_params, matmul_scope

    scope = matmul_scope(precision)  # also validates the mode name
    if impl not in IMPLS:
        # a typo'd impl must not silently route to the slow exact scan
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto" and consult_cache:
        from svd_lstm_tpu.bench.autotune import cached_impl

        hit = cached_impl(params, x, precision)
        if hit is not None and hit != "auto" and hit in valid_impls(
            params, x, precision
        ):
            impl = hit
    batched = x.ndim == 3
    # Conv hybrids: peel the causal-conv front end off FIRST (one whole-
    # sequence conv, exact f32) and recurse on the inner LSTM stack, which
    # then gets the full impl/precision dispatch below.
    if hasattr(params, "inner") or hasattr(params, "conv"):
        import jax
        import jax.numpy as jnp

        from svd_lstm_tpu.models.conv import causal_conv1d

        if hasattr(params, "inner"):  # ConvSingularParams / ConvReducedParams
            conv, inner = params.conv, params.inner
        else:  # ConvLSTMParams
            conv, inner = params.conv, StackedLSTMParams(
                layers=params.layers, head=params.head
            )
        xb = x if batched else x[None]
        h = jax.nn.relu(causal_conv1d(conv, xb.astype(jnp.float32)))
        h = h if batched else h[0]
        return predict(inner, h, impl=impl, precision=precision,
                       consult_cache=consult_cache)
    is_dense = isinstance(params, StackedLSTMParams)
    is_singular = isinstance(params, SingularModelParams)
    is_reduced = isinstance(params, ReducedModelParams)
    if not (is_dense or is_singular or is_reduced):
        raise TypeError(f"unknown model params: {type(params)}")
    if impl == "fused" and "fused" not in valid_impls(params, x, precision):
        # an explicit impl request must not silently run a different
        # implementation (and be benchmarked under the wrong label)
        raise ValueError(
            "impl='fused' (the recurrence kernel) takes batch-1 input whose "
            "layers fit ops.gpu_recurrence.MAX_UNITS at this precision (got "
            f"x.ndim={x.ndim}, widest layer {_max_units(params)}, precision "
            f"{precision!r}); use impl='scan' or impl='auto'"
        )
    if batched and precision != "exact":
        import jax.numpy as jnp

        if precision == "fast":
            # bf16 params and activations through the XLA scan (cuBLAS runs
            # the per-step product on the tensor cores). The factored forms'
            # extra intermediates cost more than they save in bf16, so
            # reconstruct to dense (exact, in f32) first.
            if is_reduced:
                from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

                params = reconstruct_dense_model(params)
            elif is_singular:
                from svd_lstm_tpu.factor.svd import singular_to_dense

                params = singular_to_dense(params)
            out = predict(cast_params(params, jnp.bfloat16), x.astype(jnp.bfloat16),
                          impl=impl, precision="exact", consult_cache=consult_cache)
            return out.astype(jnp.float32)
        with scope:
            return predict(params, x, impl=impl, precision="exact",
                           consult_cache=consult_cache)

    if impl == "fused" or (
        impl == "auto" and not batched and platform() == "gpu"
        and "fused" in valid_impls(params, x, precision)
    ):
        from svd_lstm_tpu.ops.gpu_recurrence import stack_forward

        if is_reduced:
            from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

            params = reconstruct_dense_model(params)
        elif is_singular:
            from svd_lstm_tpu.factor.svd import singular_to_dense

            params = singular_to_dense(params)
        return stack_forward(params, x, precision=_kernel_precision(precision))

    xb = x if batched else x[None]
    if is_dense:
        out = stacked_lstm_apply(params, xb, return_sequences=True)
    elif is_singular:
        out = singular_lstm_apply(params, xb, return_sequences=True)
    else:
        out = _reduced_apply(params, xb)
    return out if batched else out[0]


def _reduced_apply(params, xb):
    """The faster XLA form of a reduced model: the dense-reconstructed
    recurrence scan (one dependent product per step) beat the two-step
    scan at 3x512 r=24 batch-1 on the H100 (PERF.md)."""
    from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent

    return reduced_forward_dense_recurrent(params, xb, return_sequences=True)
