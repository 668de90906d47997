"""Int8 weight quantization — a compression axis beyond the reference.

The reference compresses along exactly one axis: SVD rank (slide 9's weight
accounting; code/svd_classes_v3.py:604-676). This module adds symmetric
per-output-column int8 quantization of the weight matrices, which

* cuts checkpoint / export / device-resident weight size 4x vs f32
  (``quantize_params`` + ``quantized_apply``: params cross HBM as int8 and
  widen on-chip inside the caller's jit), and
* could enable int8 weight *streaming* in kernels that read weights every
  step; that path needs kernel-side dequantization and is not wired.

It composes with rank truncation: quantize the reduced model's two-step
factors (B, C) after truncation. Gate math stays f32.

Scheme: for a matrix leaf ``w``, per-output-column symmetric scaling
``s = max|w| / 127`` (axis 0 reduced, keepdims) and ``q = round(w/s)`` in
int8, so ``|w - q*s| <= s/2`` elementwise. 1-D leaves (biases, sigma
vectors) stay f32 — they are tiny and sigma precision is what the whole
method trains (Hoyer fine-tune), so quantizing it would be self-defeating.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class QuantizedTensor(NamedTuple):
    """An int8-quantized matrix: ``w ~= q.astype(f32) * scale``."""

    q: jax.Array  # int8, same shape as the original
    scale: jax.Array  # f32, shape (1, ..., cols) — per-output-column

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.size * 1 + self.scale.size * 4


def quantize_tensor(w: jax.Array, axis: int = 0) -> QuantizedTensor:
    """Symmetric int8 quantization with a per-column scale (reduce ``axis``)."""
    w = jnp.asarray(w, jnp.float32)
    scale = jnp.max(jnp.abs(w), axis=axis, keepdims=True) / 127.0
    scale = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q, scale)


def dequantize_tensor(t: QuantizedTensor) -> jax.Array:
    return t.q.astype(jnp.float32) * t.scale


def _is_qt(x: Any) -> bool:
    return isinstance(x, QuantizedTensor)


def quantize_params(params: Any) -> Any:
    """Quantize every floating matrix leaf (ndim >= 2) of a parameter pytree
    to a :class:`QuantizedTensor`; 1-D leaves (biases, sigma) stay f32.

    Works on dense / singular / reduced model pytrees alike and returns the
    same NamedTuple structure, so the result checkpoints through
    ``io.checkpoint`` and feeds :func:`quantized_apply`-wrapped forwards.
    """

    def maybe_q(x):
        if _is_qt(x):  # idempotent: already-quantized leaves pass through
            return x
        if hasattr(x, "ndim") and x.ndim >= 2 and jnp.issubdtype(
            jnp.asarray(x).dtype, jnp.floating
        ):
            # split-singular factors are (4, rows, cols): reduce the ROW
            # axis within each gate so the scheme stays per-output-column
            # (reducing axis 0 there would compute one scale per element
            # from 4 samples and double the stored size)
            return quantize_tensor(x, axis=x.ndim - 2)
        return x

    # Singular layers need field-aware handling: split-mode sigma vectors
    # stack to (4, n) — 2-D — and the ndim rule alone would quantize them,
    # violating the sigma-stays-f32 contract above (sigma precision is what
    # the Hoyer fine-tune trains). Only the U/V factor matrices quantize.
    from svd_lstm_tpu.models.singular import SingularModelParams

    # Reduced layers get the C-factor compensation the binary exporter
    # applies (io/int8_export.py module docstring): C = V1^-1 V2 carries
    # the inverse's dynamic range, and a raw per-column int8 grid on it
    # costs real task accuracy (measured ~26-30% model-vs-model noise at
    # the reference scale vs 0.7% for dense —
    # scripts/int8_compensation_study.py). Re-solve C against the quantized B, then quantize.
    from svd_lstm_tpu.models.reduced import ReducedModelParams

    # Conv hybrids: the conv kernel (k, c_in, filters) quantizes per FILTER
    # — one scale over all k·c_in taps, exactly the (k·c_in × filters)
    # per-column scheme the int8 binary artifact encodes
    # (io/int8_export.py v3 conv section) — then the inner stack recurses.
    if hasattr(params, "conv"):
        from svd_lstm_tpu.models.lstm import StackedLSTMParams

        if _is_qt(params.conv.w):
            qconv = params.conv
        else:
            w = jnp.asarray(params.conv.w, jnp.float32)
            k, c_in, filters = w.shape
            qt = quantize_tensor(w.reshape(k * c_in, filters), axis=0)
            qconv = params.conv._replace(
                w=QuantizedTensor(
                    qt.q.reshape(k, c_in, filters),
                    qt.scale.reshape(1, 1, filters),
                )
            )
        if hasattr(params, "inner"):
            return params._replace(conv=qconv, inner=quantize_params(params.inner))
        inner = quantize_params(
            StackedLSTMParams(layers=params.layers, head=params.head)
        )
        return params._replace(conv=qconv, layers=inner.layers, head=inner.head)

    if isinstance(params, ReducedModelParams):
        from svd_lstm_tpu.io.int8_export import _compensated_gate_pairs

        def side(Bs, Cs):
            split = isinstance(Bs, tuple)
            if _is_qt(Bs[0] if split else Bs):  # idempotent, like maybe_q
                return Bs, Cs
            pairs = _compensated_gate_pairs(
                Bs if split else (Bs,), Cs if split else (Cs,), True
            )
            qB = tuple(maybe_q(jnp.asarray(B)) for B, _ in pairs)
            qC = tuple(maybe_q(jnp.asarray(C)) for _, C in pairs)
            return (qB, qC) if split else (qB[0], qC[0])

        layers = []
        for l in params.layers:
            wB, wC = side(l.wB, l.wC)
            uB, uC = side(l.uB, l.uC)
            layers.append(l._replace(wB=wB, wC=wC, uB=uB, uC=uC))
        head = jax.tree.map(maybe_q, params.head, is_leaf=_is_qt)
        return params._replace(layers=tuple(layers), head=head)

    if isinstance(params, SingularModelParams):
        layers = tuple(
            l._replace(
                wl=maybe_q(l.wl), wr=maybe_q(l.wr),
                ul=maybe_q(l.ul), ur=maybe_q(l.ur),
            )
            for l in params.layers
        )
        head = jax.tree.map(maybe_q, params.head, is_leaf=_is_qt)
        return params._replace(layers=layers, head=head)

    return jax.tree.map(maybe_q, params, is_leaf=_is_qt)


def dequantize_params(qparams: Any) -> Any:
    """Inverse of :func:`quantize_params`: rebuild an f32 pytree."""
    return jax.tree.map(
        lambda x: dequantize_tensor(x) if _is_qt(x) else x, qparams, is_leaf=_is_qt
    )


def quantized_apply(apply_fn):
    """Wrap a forward ``apply_fn(params, ...)`` so it accepts a quantized
    pytree. Dequantization traces inside the caller's ``jit``: weights live
    in device memory as int8 and widen on-chip."""

    def wrapped(qparams, *args, **kwargs):
        return apply_fn(dequantize_params(qparams), *args, **kwargs)

    return wrapped


# --------------------------------------------------------------------------
# Quantization-aware fine-tuning (QAT): train THROUGH the int8 grid.
#
# fake_quantize_params builds a straight-through-estimator view of the
# artifact: forward values are exactly the f32 model the int8 encoding
# represents (same leaves quantize_params targets, same C-factor
# compensation the exporter applies), gradients pass through to the f32
# master weights unchanged. Fine-tuning against this view adapts the
# weights to their own quantization grid before export — the remaining
# artifact error the post-training compensation can't remove
# (scripts/int8_compensation_study.py: reduced models keep ~11-15%
# model-vs-model noise after compensation) becomes a training signal instead.
# --------------------------------------------------------------------------


def _ste(w: jax.Array, encoded: jax.Array) -> jax.Array:
    """value = encoded, d/dw = identity (straight-through estimator)."""
    return w + jax.lax.stop_gradient(encoded - w)


def fake_quant_tensor(w: jax.Array, axis: int = 0) -> jax.Array:
    """STE view of one matrix: forward = dequantize(quantize(w))."""
    w = jnp.asarray(w, jnp.float32)
    if w.size == 0:
        return w
    return _ste(w, dequantize_tensor(quantize_tensor(w, axis)))


def _fake_quant_compensated_side(Bs, Cs):
    """STE view of one reduced side (w or u) under the exporter's
    compensated encoding (io/int8_export._compensated_gate_pairs, in jnp
    so it traces inside jit): B encodes plainly; C re-solves against the
    encoded B, then whichever of {raw C, re-solved C} reconstructs the
    second block better is the value trained against. Everything feeding
    the encoded values sits under stop_gradient, so gradients are the
    plain STE identity for both B and C."""
    split = isinstance(Bs, tuple)
    pairs = zip(Bs if split else (Bs,), Cs if split else (Cs,))
    outB, outC = [], []
    for B, C in pairs:
        B = jnp.asarray(B, jnp.float32)
        C = jnp.asarray(C, jnp.float32)
        Benc = dequantize_tensor(quantize_tensor(B, axis=0))
        outB.append(_ste(B, Benc))
        if C.size == 0:
            outC.append(C)
            continue
        target = B @ C
        C2 = jnp.linalg.lstsq(Benc, target)[0]
        Cenc = dequantize_tensor(quantize_tensor(C, axis=0))
        C2enc = dequantize_tensor(quantize_tensor(C2, axis=0))
        use_comp = jnp.linalg.norm(Benc @ C2enc - target) < jnp.linalg.norm(
            Benc @ Cenc - target
        )
        outC.append(_ste(C, jnp.where(use_comp, C2enc, Cenc)))
    if split:
        return tuple(outB), tuple(outC)
    return outB[0], outC[0]


def fake_quantize_params(params: Any) -> Any:
    """The STE (QAT) view of ``params``: same pytree structure and dtypes,
    forward values equal to what the int8 encoding represents (same leaf
    policy and reduced-model C compensation as :func:`quantize_params`),
    gradients passing straight through to ``params``.

    Head policy: follows :func:`quantize_params` (2-D heads quantize).
    The native .bin artifact additionally keeps the head exact
    (io/int8_export.py format), so its error is ≤ the view trained
    against — QAT is conservative for the .bin consumer.

    Use inside a training loss via :func:`qat_apply`; export the trained
    f32 params with the normal exporters afterwards."""

    def maybe_fq(x):
        if _is_qt(x):
            raise ValueError(
                "fake_quantize_params expects f32 master weights, not an "
                "already-quantized pytree"
            )
        if hasattr(x, "ndim") and x.ndim >= 2 and jnp.issubdtype(
            jnp.asarray(x).dtype, jnp.floating
        ):
            return fake_quant_tensor(x, axis=x.ndim - 2)
        return x

    from svd_lstm_tpu.models.reduced import ReducedModelParams
    from svd_lstm_tpu.models.singular import SingularModelParams

    # Conv hybrids: per-filter STE view of the conv kernel (the grid the
    # int8 v3 artifact encodes — see quantize_params), inner stack recurses.
    if hasattr(params, "conv"):
        from svd_lstm_tpu.models.lstm import StackedLSTMParams

        w = jnp.asarray(params.conv.w, jnp.float32)
        k, c_in, filters = w.shape
        fq = fake_quant_tensor(w.reshape(k * c_in, filters), axis=0)
        fconv = params.conv._replace(w=fq.reshape(k, c_in, filters))
        if hasattr(params, "inner"):
            return params._replace(
                conv=fconv, inner=fake_quantize_params(params.inner)
            )
        inner = fake_quantize_params(
            StackedLSTMParams(layers=params.layers, head=params.head)
        )
        return params._replace(conv=fconv, layers=inner.layers, head=inner.head)

    if isinstance(params, ReducedModelParams):
        layers = []
        for l in params.layers:
            wB, wC = _fake_quant_compensated_side(l.wB, l.wC)
            uB, uC = _fake_quant_compensated_side(l.uB, l.uC)
            layers.append(l._replace(wB=wB, wC=wC, uB=uB, uC=uC))
        head = jax.tree.map(maybe_fq, params.head, is_leaf=_is_qt)
        return params._replace(layers=tuple(layers), head=head)

    if isinstance(params, SingularModelParams):
        layers = tuple(
            l._replace(
                wl=maybe_fq(l.wl), wr=maybe_fq(l.wr),
                ul=maybe_fq(l.ul), ur=maybe_fq(l.ur),
            )
            for l in params.layers
        )
        head = jax.tree.map(maybe_fq, params.head, is_leaf=_is_qt)
        return params._replace(layers=layers, head=head)

    return jax.tree.map(maybe_fq, params, is_leaf=_is_qt)


def qat_apply(apply_fn):
    """Wrap a forward so training runs through the int8 grid:
    ``fit(params, ..., apply_fn=qat_apply(reduced_lstm_apply))`` fine-tunes
    f32 master weights against the quantized view (QAT). The returned
    params stay f32 — export them normally; the artifact then matches what
    training optimized."""

    def wrapped(params, *args, **kwargs):
        return apply_fn(fake_quantize_params(params), *args, **kwargs)

    wrapped.__name__ = f"qat_{getattr(apply_fn, '__name__', 'apply')}"
    return wrapped


def param_bytes(params: Any) -> int:
    """Device-memory footprint of a (possibly quantized) parameter pytree."""
    total = 0
    for leaf in jax.tree.leaves(params):
        total += leaf.size * jnp.dtype(leaf.dtype).itemsize
    return int(total)
