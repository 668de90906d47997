"""ctypes bindings for the native C++ streaming runtime (native/).

The runtime is the rebuilt LabVIEW-consumer role: it loads the per-gate CSV
weight export and runs state-carrying batch-1 inference with dense or exact
two-step reduced cells. Used as (a) a CPU real-time deployment path with no
Python/JAX in the loop, (b) an independent numerics oracle for the CSV
export, (c) proof the export format is externally consumable.

The shared library is built on demand with `make` (g++, no dependencies).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsvdlstm.so")


def build_native(force: bool = False) -> str:
    """Build libsvdlstm.so; returns its path. Always runs make — it is a
    no-op when the .so is newer than the source, and skipping it can load
    a stale library after a runtime change. If make fails but a prebuilt
    .so exists (a consumer box without the toolchain), the stale library
    is used with a loud warning instead of silently."""
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        if force or not os.path.exists(_LIB_PATH):
            raise
        import sys
        import warnings

        detail = ""
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            detail = e.stderr.decode(errors="replace")[-500:]
        warnings.warn(
            f"native build failed; loading PREBUILT {_LIB_PATH} which may be "
            f"stale relative to svdlstm_runtime.cpp\n{detail}",
            RuntimeWarning,
        )
        print(f"warning: make -C {_NATIVE_DIR} failed; using prebuilt .so",
              file=sys.stderr)
    return _LIB_PATH


def _load_lib():
    lib = ctypes.CDLL(build_native())
    lib.svdlstm_load.restype = ctypes.c_void_p
    lib.svdlstm_load.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.svdlstm_load_int8.restype = ctypes.c_void_p
    lib.svdlstm_load_int8.argtypes = [ctypes.c_char_p]
    lib.svdlstm_load_int8_ex.restype = ctypes.c_void_p
    lib.svdlstm_load_int8_ex.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.svdlstm_step.restype = ctypes.c_float
    lib.svdlstm_step.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.svdlstm_run.restype = None
    lib.svdlstm_run.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.svdlstm_reset.argtypes = [ctypes.c_void_p]
    lib.svdlstm_free.argtypes = [ctypes.c_void_p]
    lib.svdlstm_input_dim.restype = ctypes.c_int
    lib.svdlstm_input_dim.argtypes = [ctypes.c_void_p]
    lib.svdlstm_layer_info.restype = ctypes.c_int
    lib.svdlstm_layer_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


class NativeModel:
    """Streaming handle over the C++ runtime."""

    def __init__(
        self,
        base_dir: str,
        layer_dirs: Sequence[str],
        # one char per layer: 'd' dense; 'r' reduced with load-time
        # execution dispatch (a side whose rank can't pay for the exact
        # two-step is reconstructed to dense — the consumer never steps
        # slower than dense, mirroring the layout rule in
        # ops/layouts.py); 'R' reduced with the two-step FORCED (for
        # benchmarking the raw factored path)
        kinds: str,
        transposed: bool = False,
    ):
        self._lib = _load_lib()
        handle = self._lib.svdlstm_load(
            base_dir.encode(), ":".join(layer_dirs).encode(), kinds.encode(),
            1 if transposed else 0,
        )
        if not handle:
            raise RuntimeError(f"native runtime failed to load model from {base_dir}")
        self._h = handle

    @classmethod
    def from_export_dir(
        cls,
        base_dir: str,
        force_two_step: bool = False,
        transposed: bool | None = None,
    ) -> "NativeModel":
        """Load a weight-export directory, discovering the layers and their
        kinds from the files present: a ``lstm_<i>/`` holding ``Wi.csv`` is
        a dense layer ('d' — save_model_weights_as_csv), one holding
        ``wBi.csv`` is a two-step reduced layer ('r', or 'R' when
        ``force_two_step`` — save_reduced_weights_as_csv). Layer order is
        the numeric-suffix order of csv_weights.list_layer_dirs. This is
        the external consumer's one-call load of either export flavor
        (the LabVIEW role, reference code/load_preprocess.py:128).

        ``transposed=None`` auto-detects like load_model_from_csv: a
        directory written by save_model_weights_as_csv carries the layout
        marker and loads untransposed; a bare fixture directory (the
        shipped reference artifacts) falls back to the transposed
        convention."""
        from svd_lstm_tpu.io.csv_weights import _LAYOUT_MARKER, list_layer_dirs

        if not os.path.isdir(base_dir):
            raise RuntimeError(f"no such export directory: {base_dir}")
        if transposed is None:
            transposed = not os.path.exists(
                os.path.join(base_dir, _LAYOUT_MARKER)
            )
        layer_dirs = list_layer_dirs(base_dir)
        if not layer_dirs:
            raise RuntimeError(f"no lstm_* layer directories under {base_dir}")
        kinds = []
        for d in layer_dirs:
            p = os.path.join(base_dir, d)
            if os.path.exists(os.path.join(p, "Wi.csv")):
                kinds.append("d")
            elif os.path.exists(os.path.join(p, "wBi.csv")):
                kinds.append("R" if force_two_step else "r")
            elif os.path.exists(os.path.join(p, "wB.csv")):
                # merged-kernel reduced (one factor file per side, no gate
                # suffix — save_reduced_weights_as_csv merged form)
                kinds.append("M" if force_two_step else "m")
            else:
                raise RuntimeError(
                    f"{p}: none of Wi.csv (dense), wBi.csv (split reduced) "
                    "or wB.csv (merged reduced) found — not a weight-export "
                    "layer directory"
                )
        return cls(base_dir, layer_dirs, "".join(kinds), transposed=transposed)

    @classmethod
    def from_int8(cls, path: str, force_two_step: bool = False) -> "NativeModel":
        """Load the int8 binary artifact (io/int8_export.py) — ~4x smaller
        than the f32 CSV export; weights dequantize on load, streaming math
        stays f32. Reduced layers get the same load-time execution dispatch
        as the CSV path unless ``force_two_step``."""
        self = cls.__new__(cls)
        self._lib = _load_lib()
        handle = self._lib.svdlstm_load_int8_ex(
            path.encode(), 1 if force_two_step else 0
        )
        if not handle:
            raise RuntimeError(f"native runtime failed to load int8 artifact {path}")
        self._h = handle
        return self

    def layer_info(self, li: int) -> dict:
        """Which execution path the load-time dispatch chose for layer
        ``li``: {'w_reduced', 'u_reduced', 'units'}."""
        w = ctypes.c_int()
        u = ctypes.c_int()
        n = ctypes.c_int()
        ok = self._lib.svdlstm_layer_info(
            self._h, li, ctypes.byref(w), ctypes.byref(u), ctypes.byref(n)
        )
        if not ok:
            raise IndexError(f"no layer {li}")
        return {"w_reduced": bool(w.value), "u_reduced": bool(u.value),
                "units": n.value}

    def reset(self) -> None:
        self._lib.svdlstm_reset(self._h)

    @property
    def input_dim(self) -> int:
        """Frame width the model expects (layer 0's in_dim)."""
        # cached: step() checks it per frame on the real-time path
        d = getattr(self, "_in_dim", None)
        if d is None:
            d = self._in_dim = int(self._lib.svdlstm_input_dim(self._h))
        return d

    def step(self, frame: np.ndarray) -> float:
        frame = np.ascontiguousarray(frame, np.float32).reshape(-1)
        # the C side also refuses mismatched widths (quiet NaN); raise the
        # actionable error here before handing it a bad pointer/length
        if frame.size != self.input_dim:
            raise ValueError(
                f"frame has {frame.size} values; model expects "
                f"{self.input_dim}"
            )
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return float(self._lib.svdlstm_step(self._h, ptr, frame.size))

    def run(self, frames: np.ndarray) -> np.ndarray:
        frames = np.ascontiguousarray(frames, np.float32)
        T, d = frames.shape
        if d != self.input_dim:
            raise ValueError(
                f"frames have width {d}; model expects {self.input_dim}"
            )
        out = np.empty(T, np.float32)
        self._lib.svdlstm_run(
            self._h,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, d,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def __del__(self):
        try:
            self._lib.svdlstm_free(self._h)
        except Exception:
            pass


def save_reduced_weights_as_csv(params, savpath: str) -> None:
    """Two-step CSV export for the native runtime / external consumers.
    Split-kernel layers write per-gate files (wB{i,f,c,o}.csv, wC*.csv,
    uB*.csv, uC*.csv, b*.csv); merged-kernel layers write one file per
    factor (wB.csv, wC.csv, uB.csv, uC.csv, b.csv) — the native loader's
    'r'/'m' kinds respectively. Mixed models export layer-by-layer.

    Accepts ``ConvReducedParams`` too — the conv front end goes to
    ``conv/`` (csv_weights.save_conv_front_csv) and the runtime streams it
    through its shift-buffer conv."""
    from svd_lstm_tpu.io.csv_weights import _LAYOUT_MARKER, save_conv_front_csv

    gates = "ifco"
    os.makedirs(savpath, exist_ok=True)
    # same untransposed-layout marker as save_model_weights_as_csv, so
    # from_export_dir's auto-detection treats both export flavors alike
    with open(os.path.join(savpath, _LAYOUT_MARKER), "w") as f:
        f.write("untransposed (in_dim x units) gate blocks; two-step B/C\n")
    if hasattr(params, "inner"):  # ConvReducedParams
        save_conv_front_csv(params.conv, savpath)
        params = params.inner
    for li, layer in enumerate(params.layers):
        d = os.path.join(savpath, f"lstm_{li}")
        os.makedirs(d, exist_ok=True)
        n = layer.units
        b = np.asarray(layer.b)
        if not layer.split:
            np.savetxt(os.path.join(d, "wB.csv"), np.asarray(layer.wB), delimiter=",")
            np.savetxt(os.path.join(d, "uB.csv"), np.asarray(layer.uB), delimiter=",")
            if layer.wC.shape[1]:
                np.savetxt(os.path.join(d, "wC.csv"), np.asarray(layer.wC), delimiter=",")
            if layer.uC.shape[1]:
                np.savetxt(os.path.join(d, "uC.csv"), np.asarray(layer.uC), delimiter=",")
            np.savetxt(os.path.join(d, "b.csv"), b, delimiter=",")
            continue
        for g, name in enumerate(gates):
            np.savetxt(os.path.join(d, f"wB{name}.csv"), np.asarray(layer.wB[g]), delimiter=",")
            np.savetxt(os.path.join(d, f"uB{name}.csv"), np.asarray(layer.uB[g]), delimiter=",")
            if layer.wC[g].shape[1]:
                np.savetxt(os.path.join(d, f"wC{name}.csv"), np.asarray(layer.wC[g]), delimiter=",")
            if layer.uC[g].shape[1]:
                np.savetxt(os.path.join(d, f"uC{name}.csv"), np.asarray(layer.uC[g]), delimiter=",")
            np.savetxt(os.path.join(d, f"b{name}.csv"), b[g * n : (g + 1) * n], delimiter=",")
    dt = os.path.join(savpath, "dense_top")
    os.makedirs(dt, exist_ok=True)
    np.savetxt(os.path.join(dt, "weights.csv"), np.asarray(params.head.w), delimiter=",")
    np.savetxt(os.path.join(dt, "bias.csv"), np.asarray(params.head.b), delimiter=",")
