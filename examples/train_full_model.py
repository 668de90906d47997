"""Train the full (dense) DROPBEAR regressor.

Workflow parity with reference code/train_full_model_v4.py: preprocess at
the 500/16 µs clock → sample 20 000 random 200-step windows → 4×40 stacked
LSTM + Dense(1), adam + MSE, 30 epochs → whole-run evaluation (SNR / RMSE /
NRMSE in physical units) → prediction overlay figure → checkpoint.

Usage:
    python examples/train_full_model.py [--quick] [--out DIR]

--quick shrinks everything for a smoke run (also used by CI).
"""

import argparse
import os
import time
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="./model_saves")
    ap.add_argument("--plots", default="./plots")
    ap.add_argument(
        "--kernel", action="store_true",
        help="train through the recurrence kernel pair "
        "(TrainConfig.recurrence_kernel, TF32 in-kernel dots; step times "
        "on the H100 in PERF.md)",
    )
    ap.add_argument(
        "--remat-chunk", type=int, default=0, metavar="K",
        help="chunked-time jax.checkpoint BPTT for long windows "
        "(TrainConfig.remat_chunk: O(T/K + K) live activation memory, "
        "identical values; e.g. 512x4000-step windows need 25 GB of "
        "temps plain but 2.8 GB at K=128)",
    )
    args = ap.parse_args()

    import jax

    import svd_lstm_tpu as st
    from svd_lstm_tpu.config import DataConfig, TrainConfig
    from svd_lstm_tpu.data import preprocess
    from svd_lstm_tpu.io.checkpoint import save_params
    from svd_lstm_tpu.train.loop import fit, predict_full_run
    from svd_lstm_tpu.viz.plots import plot_prediction_overlay

    if args.quick:
        from svd_lstm_tpu.data.dropbear import preprocess_raw
        from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw

        ds = preprocess_raw(synthetic_dropbear_raw(duration=12.0), DataConfig(split_time=8.0))
        tcfg = TrainConfig(
            num_windows=2048, window_len=100, epochs=3, batch_size=64,
            recurrence_kernel=args.kernel, remat_chunk=args.remat_chunk,
        )
        units = (40, 40)
    else:
        ds = preprocess(DataConfig())
        tcfg = TrainConfig(recurrence_kernel=args.kernel,
                           remat_chunk=args.remat_chunk)
        units = (40, 40, 40, 40)

    params = st.init_stacked_lstm(jax.random.PRNGKey(tcfg.seed), 16, units)
    t0 = time.perf_counter()
    res = fit(params, ds.X_train, ds.y_train, tcfg, verbose=True)
    print(f"training wall time: {time.perf_counter() - t0:.1f} s"
          f" ({'recurrence-kernel' if args.kernel else 'XLA scan'} path)")
    print(f"rollbacks: {res.rollbacks}")

    pred = predict_full_run(res.params, ds.X)
    true_m = ds.pin_scaler.inverse_transform(ds.y.reshape(-1, 1)).ravel()
    pred_m = ds.pin_scaler.inverse_transform(pred.reshape(-1, 1)).ravel()

    print(f"SNR: {st.signaltonoise(true_m, pred_m):.3f} dB")
    print(f"RMSE: {st.rmse(true_m, pred_m):.6f} m")
    print(f"NRMSE: {st.nrmse(true_m, pred_m):.6f}")

    plot_name = (
        "full_model_prediction_quick.png" if args.quick
        else "full_model_prediction.png"
    )
    plot_prediction_overlay(
        ds.t, true_m, {"full model prediction": pred_m},
        savepath=os.path.join(args.plots, plot_name),
    )
    # --quick trains a tiny 2-layer model on synthetic data; saving it to
    # the flagship checkpoint path would poison svd_acceleration.py /
    # rank_sweep.py, which load that path blindly for the real-dataset
    # workflows. Keep the smoke artifact under a distinct name.
    ckpt_name = (
        "pretrained_sequential_quick.npz" if args.quick
        else "pretrained_sequential.npz"
    )
    save_params(os.path.join(args.out, ckpt_name), res.params)
    print(f"saved to {args.out}/{ckpt_name}")


if __name__ == "__main__":
    main()
