"""int8 artifact accuracy: dense vs reduced, plain vs compensated C.

Backs the int8 artifact compensation (utils/quantize.py). CPU-run — quantization
error is hardware-independent (exact f32 matmuls everywhere).

Measured question: what does the int8 deployment artifact
(io/int8_export.py, consumed by the native runtime / svdlstm_load_int8)
cost in task accuracy, and does the least-squares C-factor compensation
pay? The reference has no quantized export at all (its LabVIEW chain
ships f32 CSVs, code/load_preprocess.py:93-126), so this axis is
beyond-reference; the honesty bar is the same as the timing work —
measure, don't assume.

Protocol: the shipped trained checkpoint (model_saves/
pretrained_sequential.npz) -> split factorization -> rank truncation at
r in {25, 16, 8} -> whole-test-run prediction with (a) f32 weights,
(b) the int8 artifact's dequantized oracle without compensation,
(c) with compensation (the default). Reports task RMSE (scaled units)
and model-vs-model noise rel. to the f32 prediction's std.
"""

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import svd_lstm_tpu  # noqa: F401  (sets matmul precision)
from svd_lstm_tpu.data.dropbear import DataConfig, preprocess
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io.checkpoint import load_params
from svd_lstm_tpu.io.int8_export import dequantized_params
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.train.loop import predict_full_run


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def main():
    params = load_params("model_saves/pretrained_sequential.npz")
    ds = preprocess(DataConfig())
    X, yt = ds.X_test, np.asarray(ds.y_test).reshape(-1)

    # dense artifact cost, for scale
    yp = predict_full_run(params, X)
    dq_dense = dequantized_params(params)
    ypq = predict_full_run(dq_dense, X)
    print(
        f"dense 2x40: f32 rmse {rmse(yp, yt):.5f}  int8 {rmse(ypq, yt):.5f}  "
        f"noise {rmse(yp, ypq) / np.std(yp):.4f}"
    )

    sm = make_singular_model(params, merged_kernel=False)
    print(f"{'rank':>4} {'f32':>8} {'int8 plain':>18} {'int8 compensated':>18}")
    for keep in (25, 16, 8):
        rmod = make_reduced_model(sm, rank=keep)
        yp = predict_full_run(rmod, X, apply_fn=reduced_lstm_apply)
        row = f"{keep:>4} {rmse(yp, yt):>8.5f}"
        for comp in (False, True):
            dq = dequantized_params(rmod, compensate=comp)
            ypq = predict_full_run(dq, X, apply_fn=reduced_lstm_apply)
            row += f"  rmse {rmse(ypq, yt):.5f}/noise {rmse(ypq, yp) / np.std(yp):.4f}"
        print(row)


if __name__ == "__main__":
    main()
