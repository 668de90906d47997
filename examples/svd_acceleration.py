"""SVD compression pipeline: factorize → fine-tune (Hoyer) → truncate →
benchmark full vs reduced.

Workflow parity with reference code/svd_acceleration_v3.py:110-204:
load the pretrained model → make a singular (factorized) model with
hoyer=0.01, split kernels → fine-tune 10 epochs → harvest σ snapshots →
truncate at cutoff 0.05 → time full vs reduced whole-run inference →
weight counts, prediction overlay, RMSE / SNR report. The reference's
reduced model ran 1.31× slower than its full one; here both run through
``predict``'s dispatch (the recurrence kernel on the GPU at this width).

Usage:
    python examples/svd_acceleration.py [--quick] [--ckpt PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt", default="./model_saves/pretrained_sequential.npz")
    ap.add_argument("--plots", default="./plots")
    ap.add_argument("--hoyer", type=float, default=0.01)
    ap.add_argument(
        "--trace-norm", type=float, default=0.0,
        help="nuclear-norm sparsifier on the sigma vectors (beyond-reference "
        "alternative to --hoyer, composable; factor/regularizers.py)",
    )
    ap.add_argument("--orthogonal", type=float, default=0.0)
    ap.add_argument("--cutoff", type=float, default=0.05)
    ap.add_argument("--merged-kernel", action="store_true")
    ap.add_argument(
        "--kernel", action="store_true",
        help="run BOTH training stages through the recurrence kernel pair "
        "(TrainConfig.recurrence_kernel, ops/gpu_recurrence.py): the dense "
        "pre-train and the singular fine-tune via the differentiable dense "
        "reconstruction (ops/singular_train.py); step times in PERF.md",
    )
    ap.add_argument(
        "--recover-epochs", type=int, default=0,
        help="post-truncation recovery fine-tune: retrain the two-step "
        "factors (B, C, bias, head) directly for N epochs, recovering "
        "accuracy the cutoff destroyed while keeping the compressed "
        "parameterization (train/finetune.finetune_reduced; with --kernel "
        "it runs through the recurrence kernel pair via ops/reduced_train.py "
        "— beyond-reference: the reference's reduced cell is frozen, "
        "code/svd_classes_v3.py:249-315)",
    )
    ap.add_argument(
        "--qat-epochs", type=int, default=0,
        help="after truncation, fine-tune the reduced model THROUGH the "
        "int8 grid for N epochs (utils/quantize.qat_apply) so the exported "
        "int8 artifact matches what training optimized — measured 3.2x "
        "artifact-noise reduction at r=25 (scripts/qat_experiment.py)",
    )
    ap.add_argument(
        "--export", default=None, metavar="DIR",
        help="write deployment artifacts for the truncated model: per-gate "
        "two-step CSVs (io/native.py) and, for split kernels, the int8 "
        "binary (io/int8_export.py) — the reference's LabVIEW surface "
        "(code/load_preprocess.py:93-126) at the end of the same workflow",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.bench.timing import time_call
    from svd_lstm_tpu.config import DataConfig, FactorConfig, TrainConfig
    from svd_lstm_tpu.data import preprocess
    from svd_lstm_tpu.io.checkpoint import load_params
    from svd_lstm_tpu.train.finetune import finetune, harvest_sigmas
    from svd_lstm_tpu.train.loop import fit, predict_full_run
    from svd_lstm_tpu.viz.plots import plot_prediction_overlay

    if args.quick:
        from svd_lstm_tpu.data.dropbear import preprocess_raw
        from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw

        ds = preprocess_raw(synthetic_dropbear_raw(duration=12.0), DataConfig(split_time=8.0))
        ft_cfg = TrainConfig(num_windows=1024, window_len=100, epochs=2, batch_size=64,
                             recurrence_kernel=args.kernel)
        units = (40, 40)
    else:
        ds = preprocess(DataConfig())
        ft_cfg = TrainConfig(num_windows=20000, window_len=200, epochs=10, batch_size=32,
                             recurrence_kernel=args.kernel)
        units = (40, 40, 40, 40)

    if os.path.exists(args.ckpt):
        model = load_params(args.ckpt)
        print(f"loaded pretrained model from {args.ckpt}")
    else:
        print("no checkpoint found — training a fresh model first")
        model = st.init_stacked_lstm(jax.random.PRNGKey(0), 16, units)
        # pre-train with the same knobs the fine-tune uses
        model = fit(model, ds.X_train, ds.y_train, ft_cfg, verbose=True).params

    fcfg = FactorConfig(
        merged_kernel=args.merged_kernel, hoyer=args.hoyer,
        trace_norm=args.trace_norm,
        orthogonal=args.orthogonal, cutoff=args.cutoff,
    )
    smodel = st.make_singular_model(model, merged_kernel=fcfg.merged_kernel)
    print("fine-tuning singular model (Hoyer regularizer on σ)...")
    fres = finetune(smodel, ds.X_train, ds.y_train, fcfg, ft_cfg, verbose=True)
    smodel = fres.params

    sigmas = harvest_sigmas(smodel)
    for li, (sw, su) in enumerate(sigmas):
        # magnitude compare, matching truncate_singular_layer's |σ| > cutoff
        # (Hoyer updates can push entries through zero — factor/svd.py)
        below = int((np.abs(su) < fcfg.cutoff).sum())
        print(f"layer {li}: {below}/{su.size} recurrent σ below cutoff")

    rmodel = st.make_reduced_model(smodel, cutoff=fcfg.cutoff)

    if args.recover_epochs:
        import dataclasses

        from svd_lstm_tpu.train.finetune import finetune_reduced

        print("recovery fine-tune of the truncated model (B/C factors)...")
        rcfg = dataclasses.replace(ft_cfg, epochs=args.recover_epochs)
        rmodel = finetune_reduced(
            rmodel, ds.X_train, ds.y_train, train_cfg=rcfg, verbose=True
        ).params

    if args.qat_epochs:
        import dataclasses

        from svd_lstm_tpu.models.reduced import reduced_lstm_apply
        from svd_lstm_tpu.utils.quantize import qat_apply

        print("QAT fine-tune of the reduced model (int8 STE view)...")
        # the kernel engine has no QAT view; the STE wrapper runs the scan
        qcfg = dataclasses.replace(
            ft_cfg, epochs=args.qat_epochs, recurrence_kernel=False
        )
        rmodel = fit(
            rmodel, ds.X_train, ds.y_train, qcfg,
            apply_fn=qat_apply(reduced_lstm_apply), verbose=True,
        ).params

    # --- timing (protocol parity with perf_counter-around-predict in the
    # reference: host-clock median after a warm-up call)
    pred_fn = jax.jit(lambda p, x: st.predict(p, x))
    X = jnp.asarray(ds.X, jnp.float32)
    Xt = X[0, : min(X.shape[1], 16384)]
    t_full = time_call(pred_fn, model, Xt, repeats=3).median_ms
    t_red = time_call(pred_fn, rmodel, Xt, repeats=3).median_ms
    print(f"full model timing:    {t_full:.3f} ms")
    print(f"reduced model timing: {t_red:.3f} ms")
    print(f"ratio reduced/full:   {t_red/t_full:.3f}  (reference: 1.31)")

    # --- weights
    full_w = sum(int(np.asarray(x).size) for l in model.layers for x in l) + int(
        np.asarray(model.head.w).size + np.asarray(model.head.b).size
    )
    red_w = sum(l.weight_count() for l in rmodel.layers) + int(
        np.asarray(rmodel.head.w).size + np.asarray(rmodel.head.b).size
    )
    print(f"{full_w} weights in full model")
    print(f"{red_w} weights in reduced model")
    print(f"{100 - red_w / full_w * 100:.2f} percent reduction in weights")

    # --- accuracy
    fy = predict_full_run(model, ds.X)
    ry = np.asarray(red_fn(rmodel, X))[0, :, 0]
    y_m = ds.pin_scaler.inverse_transform(ds.y.reshape(-1, 1)).ravel()
    fy_m = ds.pin_scaler.inverse_transform(fy.reshape(-1, 1)).ravel()
    ry_m = ds.pin_scaler.inverse_transform(ry.reshape(-1, 1)).ravel()

    print(f"{st.rmse(y_m, ry_m):.6f} m RMSE of reduced model")
    print(f"{st.rmse(y_m, fy_m):.6f} m RMSE of full model")
    print(f"{st.rmse(y_m, ry_m)/max(st.rmse(y_m, fy_m),1e-12)*100-100:.2f} percent increase in RMSE")
    print(f"{st.signaltonoise(y_m, ry_m):.2f} dB SNR of reduced model")
    print(f"{st.signaltonoise(y_m, fy_m):.2f} dB SNR of full model")
    print(f"{st.signaltonoise(fy_m, ry_m, invert=True):.2f} dB noise from full to reduced model")

    plot_prediction_overlay(
        ds.t, y_m, {"reduced model": ry_m, "full model": fy_m},
        savepath=os.path.join(args.plots, "svd_acceleration_prediction.png"),
    )
    print(f"figure written to {args.plots}/svd_acceleration_prediction.png")

    if args.export:
        from svd_lstm_tpu.io.native import save_reduced_weights_as_csv

        os.makedirs(args.export, exist_ok=True)
        save_reduced_weights_as_csv(rmodel, args.export)
        print(f"two-step CSV export -> {args.export}/")
        if not fcfg.merged_kernel:
            from svd_lstm_tpu.io.int8_export import save_model_int8_bin

            bin_path = os.path.join(args.export, "model_int8.bin")
            nbytes = save_model_int8_bin(rmodel, bin_path)
            print(f"int8 native artifact -> {bin_path} ({nbytes} bytes)")
        else:
            print("int8 binary skipped: the artifact format is split-only")


if __name__ == "__main__":
    main()
