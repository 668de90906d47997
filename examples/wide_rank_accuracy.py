"""Accuracy-vs-rank at the wide scale (3x512, merged factorization).

The reference never published a timing result without the paired accuracy
curve (plots/RMSE_plot.png + plots/timing_plot.png,
old_versions/svd_acceleration.py:92-123), so this example supplies the pair
for the wide model: train a 3x512 stack on the DROPBEAR surrogate, truncate
the merged singular form across ranks, and report RMSE at every rank —
next to the reduced/full ``predict`` time ratio when run on the GPU
(host-clock medians, ``bench.timing``).

Artifacts: model_saves/wide_rank_accuracy.json +
plots/wide_rank_accuracy.png (consumed by tests/test_sweep_viz.py).

Usage:
    python examples/wide_rank_accuracy.py            # GPU, full run
    python examples/wide_rank_accuracy.py --quick    # CPU smoke
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

UNITS = (512, 512, 512)
RANKS = (256, 128, 64, 48, 32, 24, 16)
TIMING_T = 6656  # the bench.py wide operating point


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument(
        "--recover-epochs",
        type=int,
        default=6,
        help="max epochs for the val-gated post-truncation recovery at "
        "ranks where the timing wins (r <= 64) — the beyond-reference "
        "mechanism (the reference's reduced cell is frozen, "
        "code/svd_classes_v3.py:249-315); 0 disables. No FIXED recovery "
        "LR is rank-robust at 3x512 (round 4: the r=32-swept 3e-5 still "
        "diverged at r=48/24), so recovery runs "
        "train.finetune.recover_reduced_gated: each epoch must improve "
        "whole-run validation MSE on the TRAIN half or it is rolled back "
        "and the LR ladder steps down",
    )
    ap.add_argument(
        "--progressive",
        action="store_true",
        help="additionally run the progressive truncate-recover pipeline "
        "to r=24 (ranks 32 -> 24, re-factorizing the recovered model "
        "between stages) and record it as a 'progressive_r24' block — the "
        "rescue of the direct-truncation knife-edge at r=24",
    )
    ap.add_argument("--noise", type=float, default=1.5)
    ap.add_argument("--ckpt", default="./model_saves/pretrained_3x512_n1.5.npz")
    ap.add_argument("--out", default="./model_saves/wide_rank_accuracy.json")
    ap.add_argument("--plot", default="./plots/wide_rank_accuracy.png")
    args = ap.parse_args()
    units = (64, 64) if args.quick else UNITS
    ranks = (32, 8) if args.quick else RANKS
    if args.quick:
        for attr in ("out", "plot", "ckpt"):
            root, ext = os.path.splitext(getattr(args, attr))
            setattr(args, attr, f"{root}_quick{ext}")

    import jax
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.config import DataConfig, TrainConfig
    from svd_lstm_tpu.data.dropbear import preprocess_raw
    from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw
    from svd_lstm_tpu.io.checkpoint import load_params, save_params
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.train.loop import fit, predict_full_run
    from svd_lstm_tpu.train.metrics import rmse

    on_gpu = jax.devices()[0].platform == "gpu"
    print(f"devices: {jax.devices()}", flush=True)

    dcfg = DataConfig()
    ds = preprocess_raw(
        synthetic_dropbear_raw(
            duration=12.0 if args.quick else 42.0, noise=args.noise
        ),
        dataclasses.replace(dcfg, split_time=8.0) if args.quick else dcfg,
    )

    if os.path.exists(args.ckpt):
        model = load_params(args.ckpt)
        print(f"loaded {args.ckpt}")
    else:
        tcfg = TrainConfig(
            epochs=2 if args.quick else args.epochs,
            batch_size=32 if args.quick else 128,
            num_windows=512 if args.quick else 20_000,
            window_len=50 if args.quick else 200,
            recurrence_kernel=on_gpu,
        )
        print(f"training {'x'.join(map(str, units))} "
              f"({tcfg.epochs} epochs, kernel={tcfg.recurrence_kernel})...",
              flush=True)
        model = fit(
            st.init_stacked_lstm(jax.random.PRNGKey(0), dcfg.frame_width, units),
            ds.X_train, ds.y_train, tcfg, verbose=True,
        ).params
        save_params(args.ckpt, model)

    inv = lambda v: ds.pin_scaler.inverse_transform(  # noqa: E731
        np.asarray(v).reshape(-1, 1)
    ).ravel()
    y_true = inv(ds.y_test)
    full_pred = inv(predict_full_run(model, ds.X_test))
    full_rmse = rmse(y_true, full_pred)
    full_w = sum(int(np.asarray(a).size) for l in model.layers for a in l)
    # fast-precision accuracy column: predict(precision='fast') on batch-1
    # input; at 512 units that is the exact scan (api.py: the kernel takes
    # at most 128 units), so the fast columns equal exact.
    x_test1 = jnp.asarray(ds.X_test[0])
    fast_fn = jax.jit(lambda p, xx: st.predict(p, xx, precision="fast"))
    full_fast_rmse = rmse(y_true, inv(np.asarray(fast_fn(model, x_test1))[:, 0]))
    print(f"full model: RMSE {full_rmse*1000:.3f} mm "
          f"(fast {full_fast_rmse*1000:.3f} mm)  weights {full_w}",
          flush=True)

    # timing: the bench.py wide protocol (batch-1, T=6656, predict)
    x_time = jnp.asarray(
        np.random.default_rng(1).normal(size=(TIMING_T, dcfg.frame_width)),
        jnp.float32,
    )
    full_ms = None
    if on_gpu:
        from svd_lstm_tpu.bench.timing import time_call

        time_fn = jax.jit(lambda p, xx: st.predict(p, xx))
        full_ms = time_call(time_fn, model, x_time).median_ms
        print(f"full timing: {full_ms:.3f} ms (T={TIMING_T}, batch-1)", flush=True)

    smodel = st.make_singular_model(model, merged_kernel=True)
    rows = []
    recover_recipe = None  # stamped from the first gated run
    for r in ranks:
        rmod = st.make_reduced_model(smodel, rank=r)
        pred = inv(predict_full_run(rmod, ds.X_test, apply_fn=reduced_lstm_apply))
        e = rmse(y_true, pred)
        red_w = sum(l.weight_count() for l in rmod.layers)
        e_fast = rmse(y_true, inv(np.asarray(fast_fn(rmod, x_test1))[:, 0]))
        row = {
            "rank": r,
            "rmse_mm": round(float(e * 1000), 4),
            "rmse_ratio": round(float(e / full_rmse), 4),
            # fast-vs-fast: the 0.547 timing headline's accuracy pairing
            "rmse_fast_mm": round(float(e_fast * 1000), 4),
            "rmse_fast_ratio": round(float(e_fast / full_fast_rmse), 4),
            "weights": red_w,
            "weight_ratio": round(red_w / full_w, 4),
        }
        if args.recover_epochs and r <= 64:
            # post-truncation recovery (beyond-reference: the reference's
            # ReducedLSTMCell is frozen; ours trains). Val-gated with LR
            # backoff — monotone in validation MSE by construction, so a
            # rank where every ladder LR diverges degrades to "no
            # recovery" instead of shipping a worse model (the round-4
            # artifact's r=48/24 failure mode).
            from svd_lstm_tpu.train.finetune import recover_reduced_gated

            rcfg = TrainConfig(
                batch_size=32 if args.quick else 128,
                num_windows=512 if args.quick else 20_000,
                window_len=50 if args.quick else 200,
            )
            rec, rinfo = recover_reduced_gated(
                rmod, ds.X_train, ds.y_train, train_cfg=rcfg,
                max_epochs=args.recover_epochs, verbose=True,
            )
            recover_recipe = {
                k: rinfo[k] for k in ("recipe", "lr_ladder", "clip",
                                      "max_epochs", "gate")
            }
            pred_r = inv(
                predict_full_run(rec, ds.X_test, apply_fn=reduced_lstm_apply)
            )
            e_r = rmse(y_true, pred_r)
            row["rmse_recovered_mm"] = round(float(e_r * 1000), 4)
            row["recovered_ratio"] = round(float(e_r / full_rmse), 4)
            row["recovery"] = {
                "accepted_epochs": rinfo["accepted_epochs"],
                "raw_val_mse": round(rinfo["raw_val_mse"], 6),
                "best_val_mse": round(rinfo["best_val_mse"], 6),
                "trace": rinfo["trace"],
            }
        if on_gpu:
            red_ms = time_call(time_fn, rmod, x_time).median_ms
            row["reduced_ms"] = round(red_ms, 4)
            row["timing_ratio"] = round(red_ms / full_ms, 4)
        rows.append(row)
        print(f"r={r:3d}: RMSE {row['rmse_mm']:8.3f} mm "
              f"(x{row['rmse_ratio']:.3f})  weights x{row['weight_ratio']:.3f}"
              + (f"  recovered x{row['recovered_ratio']:.3f}"
                 if "recovered_ratio" in row else "")
              + (f"  time x{row['timing_ratio']:.3f}" if on_gpu else ""),
              flush=True)

    progressive = None
    if args.progressive:
        # progressive truncate -> recover -> re-factorize schedule down to
        # r=24 (direct truncation there is a measured knife-edge that the
        # gated recovery correctly refuses)
        from svd_lstm_tpu.train.finetune import truncate_recover_progressive

        ranks = (32, 24) if not args.quick else (8, 4)
        rcfg = TrainConfig(
            batch_size=32 if args.quick else 128,
            num_windows=512 if args.quick else 20_000,
            window_len=50 if args.quick else 200,
        )
        print(f"progressive pipeline: ranks {ranks}...", flush=True)
        rprog, infos = truncate_recover_progressive(
            model, ds.X_train, ds.y_train, ranks=ranks, train_cfg=rcfg,
            max_epochs=args.recover_epochs, verbose=True,
        )
        e_p = rmse(y_true, inv(
            predict_full_run(rprog, ds.X_test, apply_fn=reduced_lstm_apply)
        ))
        e_pf = rmse(y_true, inv(np.asarray(fast_fn(rprog, x_test1))[:, 0]))
        progressive = {
            "ranks": list(ranks),
            "rmse_mm": round(float(e_p * 1000), 4),
            "rmse_ratio": round(float(e_p / full_rmse), 4),
            "rmse_fast_mm": round(float(e_pf * 1000), 4),
            "rmse_fast_ratio": round(float(e_pf / full_fast_rmse), 4),
            "stages": [
                {"rank": i["rank"], "accepted_epochs": i["accepted_epochs"],
                 "raw_val_mse": round(i["raw_val_mse"], 6),
                 "best_val_mse": round(i["best_val_mse"], 6)}
                for i in infos
            ],
        }
        print(f"progressive r={ranks[-1]}: RMSE ratio "
              f"{progressive['rmse_ratio']:.3f}  fast "
              f"{progressive['rmse_fast_ratio']:.3f}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(
            {
                "config": {
                    "units": units,
                    "merged_kernel": True,
                    "noise": args.noise,
                    "dataset": "synthetic DROPBEAR surrogate"
                    + (" (quick)" if args.quick else ""),
                    "on_gpu": on_gpu,
                    "recover": recover_recipe,
                },
                "full_rmse_mm": round(float(full_rmse * 1000), 4),
                "full_rmse_fast_mm": round(float(full_fast_rmse * 1000), 4),
                "progressive_r24": progressive,
                "full_weights": full_w,
                "full_ms": full_ms,
                "rows": rows,
            },
            f,
            indent=1,
        )
    print(f"wrote {args.out}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(7, 4.2))
    rs = [row["rank"] for row in rows]
    ax1.plot(rs, [row["rmse_ratio"] for row in rows], "o-", color="tab:blue",
             label="RMSE(reduced)/RMSE(full)")
    rec_pts = [(row["rank"], row["recovered_ratio"]) for row in rows
               if "recovered_ratio" in row]
    if rec_pts:
        ax1.plot(*zip(*rec_pts), "^-", color="tab:green",
                 label="after recovery fine-tune")
        ax1.legend(loc="upper left", fontsize=8)
    ax1.axhline(1.0, color="gray", lw=0.6)
    ax1.set_xlabel("retained rank r (of 512)")
    ax1.set_ylabel("RMSE ratio", color="tab:blue")
    ax1.set_xscale("log", base=2)
    ax1.invert_xaxis()
    if on_gpu:
        ax2 = ax1.twinx()
        ax2.plot(rs, [row["timing_ratio"] for row in rows], "s--",
                 color="tab:red", label="time(reduced)/time(full)")
        ax2.set_ylabel("time ratio (predict, host clock)", color="tab:red")
        ax2.axhline(1.0, color="tab:red", lw=0.5, ls=":")
    fig.suptitle("3x512 merged truncation: accuracy vs rank")
    fig.tight_layout()
    fig.savefig(args.plot, dpi=120)
    print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
