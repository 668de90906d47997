"""int8 binary deployment artifact for the native runtime.

The reference's deployment chain exports f32 per-gate CSVs for a LabVIEW
real-time consumer (reference code/load_preprocess.py:93-126). This module
adds the compressed variant: one little-endian binary file holding every
weight matrix int8-quantized per output column (utils/quantize.py scheme:
``w ~= q * scale``, ``scale = max|col|/127``) — ~4x smaller than the f32
CSVs, consumed directly by the native C++ runtime (``svdlstm_load_int8``),
which dequantizes on load so the streaming math stays f32.

Format (all little-endian; "qmat" = u32 rows, u32 cols, f32 scale[cols],
i8 data[rows*cols] row-major; "fvec" = u32 len, f32 data[len]):

    magic  "SVDL8BIN"            (8 bytes)
    u32    version (2 for pure LSTM stacks — version-1 files have no 'm'
           kind and stay readable; 3 when a conv front end is present)
    u32    n_layers
    [version 3 only] u8 has_conv; if 1: u32 k, u32 c_in,
           qmat w ((k·c_in) x filters, tap-major rows), fvec b (filters)
    per layer:
      u8   kind: 'd' dense | 'r' reduced (split) | 'm' reduced (merged)
      dense:   qmat W (in x 4n), qmat U (n x 4n), fvec b (4n)
      reduced 'r': per gate g in [i,f,c,o]: qmat wB_g, qmat wC_g (cols may
               be 0 at full rank); then per gate: qmat uB_g, qmat uC_g;
               then fvec b (4n)
      reduced 'm': qmat wB (in x r), qmat wC (r x 4n-r), qmat uB, qmat uC,
               fvec b (4n) — one SVD per side spanning all four gates
    head: fvec w (n), f32 bias

Gate order and column conventions match io/csv_weights.py so the same
model round-trips through either artifact.

Reduced models get **compensated quantization** (default on): the two-step
second factor ``C = V1^-1 V2`` (reference code/svd_classes_v3.py:656-660)
carries the inverse's dynamic range (measured max|C| up to ~800 vs ~0.5
for B at the reference scale), so a per-column int8 grid on the raw C is
coarse enough to cost real task accuracy (~26% model-vs-model noise at
4x40/r=25 where the dense artifact costs 0.7% — scripts/int8_compensation_study.py
artifact compensation). Before quantizing C, it is re-solved against the
*already-quantized* B — ``C' = argmin ||deq(q(B)) C' - B C||_F`` (a
data-free least-squares compensation in the spirit of sequential
post-training quantization methods) — which absorbs B's rounding error
into C and measurably halves the artifact's noise. No format change:
consumers see the same qmat layout, just better values.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"SVDL8BIN"
VERSION = 2


def _q(mat: np.ndarray):
    """Per-output-column symmetric int8 quantization (utils/quantize.py
    scheme, reimplemented in numpy so export needs no device)."""
    w = np.asarray(mat, np.float32)
    if w.size == 0:
        return np.zeros(w.shape, np.int8), np.zeros((w.shape[1],), np.float32)
    scale = np.max(np.abs(w), axis=0) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _dq(mat: np.ndarray) -> np.ndarray:
    """The f32 matrix the int8 artifact encodes for ``mat``."""
    q, scale = _q(mat)
    return (q.astype(np.float32) * scale).astype(np.float32)


def _compensated_gate_pairs(Bs, Cs, compensate: bool):
    """The (B, C) pairs actually encoded for one side (w or u) of a split
    reduced layer. With ``compensate`` (the default), C is re-solved
    against the quantized B before its own quantization:
    ``C' = lstsq(deq(q(B)), B @ C)`` — see the module docstring. Shared by
    the exporter and :func:`dequantized_params` so the artifact and its
    oracle can never disagree."""
    out = []
    for B, C in zip(Bs, Cs):
        B = np.asarray(B, np.float32)
        C = np.asarray(C, np.float32)
        if compensate and C.size:
            Bdq = _dq(B)
            target = B @ C
            C2 = np.linalg.lstsq(Bdq, target, rcond=None)[0].astype(np.float32)
            # The re-solve can inflate C's dynamic range (pinv against a
            # nearly-rank-deficient quantized B coarsens C2's own int8
            # grid — measured at 4x40/r=8). Keep whichever ENCODING
            # reconstructs the second block better, so compensation never
            # loses: both branches are deterministic, so the exporter and
            # the oracle make the same choice.
            if np.linalg.norm(Bdq @ _dq(C2) - target) < np.linalg.norm(
                Bdq @ _dq(C) - target
            ):
                C = C2
        out.append((B, C))
    return out


def _write_qmat(f, mat: np.ndarray) -> None:
    q, scale = _q(mat)
    rows, cols = q.shape
    f.write(struct.pack("<II", rows, cols))
    f.write(scale.tobytes())
    f.write(np.ascontiguousarray(q).tobytes())


def _write_fvec(f, v: np.ndarray) -> None:
    v = np.asarray(v, np.float32).reshape(-1)
    f.write(struct.pack("<I", v.size))
    f.write(v.tobytes())


def save_model_int8_bin(params, path: str, compensate: bool = True) -> int:
    """Write a dense (StackedLSTMParams), reduced (ReducedModelParams) or
    conv-hybrid (ConvLSTMParams / ConvReducedParams) model as the int8
    binary artifact. Returns the file size in bytes.

    ``compensate`` (default True) applies the least-squares C-factor
    compensation described in the module docstring to reduced models;
    pass False for the raw per-matrix quantization (A/B measurement:
    scripts/int8_compensation_study.py)."""
    from svd_lstm_tpu.models.conv import ConvLSTMParams, ConvReducedParams
    from svd_lstm_tpu.models.lstm import StackedLSTMParams
    from svd_lstm_tpu.models.reduced import ReducedModelParams

    conv = None
    if isinstance(params, ConvLSTMParams):
        conv = params.conv
        params = StackedLSTMParams(layers=params.layers, head=params.head)
    elif isinstance(params, ConvReducedParams):
        conv = params.conv
        params = params.inner

    head_b = np.asarray(params.head.b).reshape(-1)
    if head_b.size != 1:
        # the artifact (and the native runtime's scalar y = b + w·h,
        # svdlstm_runtime.cpp) encodes a single-output head; a multi-output
        # model would silently lose all but the first bias
        raise ValueError(
            f"int8 binary export supports a single-output head, got "
            f"head_dim={head_b.size}"
        )
    # Validate EVERYTHING before opening the file — a mid-stream raise
    # would leave a truncated artifact at the target path for the native
    # consumer to choke on.
    if not isinstance(params, (StackedLSTMParams, ReducedModelParams)):
        raise TypeError(f"unsupported model params: {type(params)}")
    with open(path, "wb") as f:
        f.write(MAGIC)
        version = 3 if conv is not None else VERSION
        f.write(struct.pack("<II", version, len(params.layers)))
        if conv is not None:
            w = np.asarray(conv.w, np.float32)  # (k, c_in, filters)
            k, c_in, filters = w.shape
            f.write(struct.pack("<B", 1))
            f.write(struct.pack("<II", k, c_in))
            _write_qmat(f, w.reshape(k * c_in, filters))
            _write_fvec(f, np.asarray(conv.b))
        for layer in params.layers:
            if isinstance(params, StackedLSTMParams):
                f.write(b"d")
                _write_qmat(f, np.asarray(layer.W))
                _write_qmat(f, np.asarray(layer.U))
                _write_fvec(f, np.asarray(layer.b))
            elif layer.split:  # ReducedModelParams, per-gate factors
                f.write(b"r")
                for side_B, side_C in ((layer.wB, layer.wC), (layer.uB, layer.uC)):
                    for B, C in _compensated_gate_pairs(side_B, side_C, compensate):
                        _write_qmat(f, B)
                        _write_qmat(f, C)
                _write_fvec(f, np.asarray(layer.b))
            else:  # ReducedModelParams, merged — one factor pair per side
                f.write(b"m")
                for side_B, side_C in ((layer.wB, layer.wC), (layer.uB, layer.uC)):
                    ((B, C),) = _compensated_gate_pairs((side_B,), (side_C,), compensate)
                    _write_qmat(f, B)
                    _write_qmat(f, C)
                _write_fvec(f, np.asarray(layer.b))
        _write_fvec(f, np.asarray(params.head.w).reshape(-1))
        f.write(struct.pack("<f", float(np.asarray(params.head.b).reshape(-1)[0])))
    import os

    return os.path.getsize(path)


def dequantized_params(params, compensate: bool = True):
    """The f32 model the int8 artifact actually encodes (quantize +
    dequantize every matrix; biases/head exact) — the oracle the native
    runtime must match. ``compensate`` must match what
    :func:`save_model_int8_bin` was called with (both default True)."""
    from svd_lstm_tpu.models.conv import (
        ConvLSTMParams,
        ConvParams,
        ConvReducedParams,
    )
    from svd_lstm_tpu.models.lstm import LSTMLayerParams, StackedLSTMParams
    from svd_lstm_tpu.models.reduced import ReducedLayerParams, ReducedModelParams

    if isinstance(params, (ConvLSTMParams, ConvReducedParams)):
        w = np.asarray(params.conv.w, np.float32)
        k, c_in, filters = w.shape
        conv_dq = ConvParams(
            w=_dq(w.reshape(k * c_in, filters)).reshape(k, c_in, filters),
            b=np.asarray(params.conv.b),
        )
        if isinstance(params, ConvLSTMParams):
            inner = dequantized_params(
                StackedLSTMParams(layers=params.layers, head=params.head),
                compensate,
            )
            return ConvLSTMParams(conv=conv_dq, layers=inner.layers, head=inner.head)
        return ConvReducedParams(
            conv=conv_dq, inner=dequantized_params(params.inner, compensate)
        )

    if isinstance(params, StackedLSTMParams):
        layers = tuple(
            LSTMLayerParams(W=_dq(l.W), U=_dq(l.U), b=np.asarray(l.b))
            for l in params.layers
        )
        return StackedLSTMParams(layers=layers, head=params.head)
    def side(Bs, Cs):
        split = isinstance(Bs, tuple)
        pairs = _compensated_gate_pairs(
            Bs if split else (Bs,), Cs if split else (Cs,), compensate
        )
        qB = tuple(_dq(B) for B, _ in pairs)
        qC = tuple(_dq(C) if C.size else C for _, C in pairs)
        return (qB, qC) if split else (qB[0], qC[0])

    layers = []
    for l in params.layers:
        wB, wC = side(l.wB, l.wC)
        uB, uC = side(l.uB, l.uC)
        layers.append(
            ReducedLayerParams(wB=wB, wC=wC, uB=uB, uC=uC, b=np.asarray(l.b))
        )
    return ReducedModelParams(layers=tuple(layers), head=params.head)
