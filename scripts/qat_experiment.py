"""Quantization-aware fine-tuning (QAT) of the reduced model before export.

Backs quantization-aware training (utils/quantize.qat_apply). CPU-run — quantization error and the STE
training mechanics are hardware-independent.

After the exporter's post-training C compensation
(scripts/int8_compensation_study.py), the reduced int8 artifact still
carries ~11-15% model-vs-model noise at the ranks where quantization
hurts (vs 0.7% for dense). QAT turns that residual into a training
signal: fine-tune the reduced model's f32 master weights THROUGH the
int8 view (utils/quantize.fake_quantize_params — forward = the artifact
encoding incl. compensation, gradient = straight-through identity), so
the weights settle where their own grid represents them well.

Protocol: shipped trained checkpoint -> split factorization -> rank-25
truncation -> measure the artifact -> 3-epoch QAT fine-tune
(fit(apply_fn=qat_apply(reduced_lstm_apply)), 2048 windows x 100 steps,
adam 3e-4) -> re-measure. The reference has no quantized deployment path
at all (f32 CSVs only, code/load_preprocess.py:93-126).
"""

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import svd_lstm_tpu as st
from svd_lstm_tpu.config import TrainConfig
from svd_lstm_tpu.data.dropbear import DataConfig, preprocess
from svd_lstm_tpu.io.checkpoint import load_params
from svd_lstm_tpu.io.int8_export import dequantized_params
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.train.loop import fit, predict_full_run
from svd_lstm_tpu.utils.quantize import qat_apply


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def main():
    params = load_params("model_saves/pretrained_sequential.npz")
    ds = preprocess(DataConfig())
    X, yt = ds.X_test, np.asarray(ds.y_test).reshape(-1)

    red = st.make_reduced_model(
        st.make_singular_model(params, merged_kernel=False), rank=25
    )
    yp = predict_full_run(red, X, apply_fn=reduced_lstm_apply)
    yq = predict_full_run(dequantized_params(red), X, apply_fn=reduced_lstm_apply)
    print(
        f"before QAT: f32 task {rmse(yp, yt):.5f}  artifact task "
        f"{rmse(yq, yt):.5f}  noise {rmse(yq, yp) / np.std(yp):.4f}"
    )

    cfg = TrainConfig(
        epochs=3, num_windows=2048, window_len=100, batch_size=32,
        learning_rate=3e-4, seed=0,
    )
    res = fit(
        red, ds.X_train, ds.y_train, cfg,
        apply_fn=qat_apply(reduced_lstm_apply), verbose=True,
    )
    yf = predict_full_run(res.params, X, apply_fn=reduced_lstm_apply)
    yq = predict_full_run(
        dequantized_params(res.params), X, apply_fn=reduced_lstm_apply
    )
    print(
        f"after QAT:  f32 task {rmse(yf, yt):.5f}  artifact task "
        f"{rmse(yq, yt):.5f}  noise {rmse(yq, yf) / np.std(yf):.4f}"
    )


if __name__ == "__main__":
    main()
