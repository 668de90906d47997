"""Distributed training demo: the reference workflow's two training
stages (dense pre-train + singular fine-tune,
reference code/train_full_model_v4.py:98-126 /
svd_acceleration_v3.py:110-204) scaled over a jax.sharding.Mesh.

On real multi-GPU hardware the same code runs over NVLink; here
it demos on whatever devices exist — pass --virtual N to fake an N-device
CPU mesh (the test/CI configuration).

Run:
    python examples/distributed_training.py --quick --virtual 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--virtual", type=int, default=0,
        help="force an N-device virtual CPU mesh (must come before jax init)",
    )
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel factor for the dense stage demo step")
    args = ap.parse_args()

    if args.virtual:
        # replace (not just append) any inherited device-count flag so
        # --virtual N always wins
        flags = [
            f
            for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f
        ]
        flags.append(f"--xla_force_host_platform_device_count={args.virtual}")
        os.environ["XLA_FLAGS"] = " ".join(flags)
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if args.virtual:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass

    import numpy as np

    import svd_lstm_tpu as st
    from svd_lstm_tpu.config import DataConfig, FactorConfig, TrainConfig
    from svd_lstm_tpu.data.dropbear import preprocess_raw
    from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw
    from svd_lstm_tpu.parallel.fit import finetune_dp, fit_dp
    from svd_lstm_tpu.parallel.mesh import make_mesh
    from svd_lstm_tpu.train.loop import predict_full_run

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} × {jax.devices()[0].platform}")
    mesh = make_mesh(dp=n_dev, tp=1)

    ds = preprocess_raw(
        synthetic_dropbear_raw(duration=12.0), DataConfig(split_time=8.0)
    )
    # round the batch to a multiple of the device count (fit_dp contract)
    bs = 64 if 64 % n_dev == 0 else n_dev * max(1, 64 // n_dev)
    if args.quick:
        cfg = TrainConfig(num_windows=512, window_len=80, epochs=2, batch_size=bs)
        units = (40, 40)
    else:
        cfg = TrainConfig(epochs=10, batch_size=bs)
        units = (40, 40, 40, 40)

    # stage 1: dense pre-train, data-parallel over every device
    params = st.init_stacked_lstm(jax.random.PRNGKey(0), 16, units)
    res = fit_dp(params, ds.X_train, ds.y_train, mesh, cfg=cfg, verbose=True)
    print(f"dense dp-train: loss {res.history[0]:.4f} -> {res.history[-1]:.4f}")

    # stage 2: factorize + dp singular fine-tune (σ-only + Hoyer)
    sparams = st.make_singular_model(res.params, merged_kernel=False)
    fres = finetune_dp(
        sparams, ds.X_train, ds.y_train, mesh,
        factor_cfg=FactorConfig(hoyer=0.01),
        train_cfg=cfg,
        verbose=True,
    )
    print(f"singular dp-finetune: loss {fres.history[-1]:.4f}")

    # stage 3: truncate, dp recovery fine-tune (beyond-reference: the
    # reference's reduced cell is frozen, code/svd_classes_v3.py:249-315),
    # then predict
    rmodel = st.make_reduced_model(fres.params, cutoff=0.05)
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.parallel.fit import finetune_reduced_dp

    rres = finetune_reduced_dp(rmodel, ds.X_train, ds.y_train, mesh,
                               train_cfg=cfg)
    rmodel = rres.params
    print(f"reduced dp-recovery: loss {rres.history[0]:.4f} -> "
          f"{rres.history[-1]:.4f}")

    pred = predict_full_run(rmodel, ds.X_test, apply_fn=reduced_lstm_apply)
    print(f"reduced prediction finite: {np.isfinite(pred).all()}  "
          f"({pred.shape[0]} steps)")

    # stage 4: pipeline-parallel whole-run inference — batch-1 single long
    # sequence over a pp axis (layer stages + chunked-time wavefront,
    # parallel/pipeline.py), the one workload dp can't shard; here on the
    # compressed model via its exact folded two-step stage packing
    from svd_lstm_tpu.parallel.pipeline import make_pipeline_inference

    S = min(len(units), n_dev)
    while len(units) % S:
        S -= 1
    T = min(ds.X_test.shape[1], 1024 if args.quick else 8192)
    x1 = ds.X_test[:, :T]
    pp_run = make_pipeline_inference(mesh, n_stages=S, ct=128)
    pp_pred = np.asarray(pp_run(rmodel, x1))[0, :, 0]
    err = float(np.max(np.abs(pp_pred - pred[:T])))
    print(f"pp inference ({S} stages, T={T}): max|pp - direct| = {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    main()
