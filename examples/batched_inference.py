"""BASELINE stretch config: batched multi-sequence inference sharded over a
device mesh.

The recurrence is inherently sequential in time, so multi-chip scaling
shards *independent sequences* across devices (SURVEY §5). Runs on any
mesh — including the 8-virtual-CPU-device mesh used in CI.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/batched_inference.py [--wide]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wide", action="store_true", help="use the 3x512 stretch model")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--quick", action="store_true", help="tiny shapes for a CPU smoke run")
    ap.add_argument(
        "--precision", default="exact", choices=["exact", "high", "fast"],
        help="predict precision for the sharded forward ('high' = TF32, "
        "'fast' = bf16; errors and speed on the H100 in PERF.md)",
    )
    ap.add_argument(
        "--rank", type=int, default=0,
        help="also run an SVD-reduced model (two-step, keep-rank R per "
        "gate) through the same dp-sharded inference path",
    )
    args = ap.parse_args()
    if args.quick:
        args.batch, args.steps = 4, 32

    import jax
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.bench.timing import time_call
    from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
    from svd_lstm_tpu.parallel.mesh import make_mesh
    from svd_lstm_tpu.parallel.train import make_batched_inference

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")
    units = (512, 512, 512) if args.wide else (40, 40, 40, 40)
    B = (args.batch // n_dev) * n_dev or n_dev

    params = init_stacked_lstm(jax.random.PRNGKey(0), 16, units)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(B, args.steps, 16)), jnp.float32)

    mesh = make_mesh(dp=n_dev, tp=1)

    def apply(p, xx, return_sequences=True):
        return st.predict(p, xx, precision=args.precision, consult_cache=False)

    run = make_batched_inference(mesh, apply)
    timing = time_call(run, params, X, repeats=3)
    dt_ms = timing.median_ms
    out = run(params, X)
    out = jnp.asarray(out, jnp.float32)
    if args.precision == "exact":
        ref = stacked_lstm_apply(params, X[: B // n_dev], return_sequences=True)
        err = float(jnp.abs(out[: B // n_dev] - ref).max())
        err_note = f"shard-vs-local err {err:.2e}"
    else:
        # comparing a reduced-precision forward against exact f32 would
        # mislabel its roundoff (~1e-2 for fast) as sharding error; the
        # sharded≡unsharded parity is asserted in exact mode above and in
        # tests/test_parallel.py
        err_note = f"precision={args.precision} (roundoff vs f32 expected)"
    print(
        f"sharded {B} sequences x {args.steps} steps over {n_dev} devices: "
        f"{dt_ms:.1f} ms (host-clock median), "
        f"{B*args.steps/(dt_ms/1e3)/1e6:.2f} M steps/s, "
        f"{err_note}"
    )

    if args.rank:
        # SVD-reduced model through the SAME dp-sharded path: compress,
        # then shard the independent sequences.
        from svd_lstm_tpu.models.reduced import reduced_lstm_apply

        smodel = st.make_singular_model(params, merged_kernel=False)
        rmodel = st.make_reduced_model(smodel, rank=args.rank)
        run_r = make_batched_inference(mesh, reduced_lstm_apply)
        out_r = jax.block_until_ready(run_r(rmodel, X))
        dt_r_ms = time_call(run_r, rmodel, X, repeats=3).median_ms
        err_r = float(jnp.abs(jnp.asarray(out_r, jnp.float32) - jnp.asarray(out, jnp.float32)).max())
        n_min = min(units)
        if args.precision != "exact":
            note = (
                f"compared against the precision={args.precision!r} full output "
                "— dominated by its reduced-precision roundoff"
            )
        elif args.rank >= n_min:
            note = "exact two-step reconstruction — should be ~1e-6"
        else:
            note = f"genuine truncation (r={args.rank} < n={n_min}) — error reflects discarded sigmas"
        print(
            f"reduced (r={args.rank}) sharded: {dt_r_ms:.1f} ms, "
            f"{B*args.steps/(dt_r_ms/1e3)/1e6:.2f} M steps/s, "
            f"reduced-vs-full err {err_r:.2e} ({note})"
        )


if __name__ == "__main__":
    main()
