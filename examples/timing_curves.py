"""Timing-vs-rank curve — regenerates the reference's published timing
figure (plots/timing_plot.png) with this framework's numbers.

The reference's timing plot showed ratio ≈ 1.31–1.39 at every rank cut (its
compressed model was always slower). Here each rank cut is the host-clock
median of ``predict`` on the reduced model over that of the full model,
both through the same dispatch (``bench.timing``: warm-up and compilation
excluded, each call ended by ``block_until_ready``). Times mean something
only on the GPU; a CPU run is a smoke test of the workflow.

Usage:
    python examples/timing_curves.py [--quick] [--wide] [--fast]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plots", default="./plots")
    ap.add_argument("--T", type=int, default=6656)
    ap.add_argument("--wide", action="store_true",
                    help="3x512 merged factorization instead of the 4x40 split one")
    ap.add_argument("--fast", action="store_true", help="predict(precision='fast')")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.bench.timing import time_call
    from svd_lstm_tpu.models.lstm import init_stacked_lstm
    from svd_lstm_tpu.viz.plots import plot_timing_curve

    if jax.devices()[0].platform != "gpu":
        print("NOTE: timings are meaningful on the GPU; this run is a smoke test.")
    if args.wide:
        units, merged = (512, 512, 512), True
        ranks = [64, 32] if args.quick else [256, 128, 64, 32, 16]
    else:
        units, merged = ((40, 40) if args.quick else (40, 40, 40, 40)), False
        ranks = [units[0] - k for k in ([1, 5, 10, 15] if args.quick
                                        else [1, 3, 5, 7, 9, 11, 13, 15, 17, 19])]
    T = 512 if args.quick else args.T
    precision = "fast" if args.fast else "exact"

    params = init_stacked_lstm(jax.random.PRNGKey(0), 16, units)
    smodel = st.make_singular_model(params, merged_kernel=merged)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(T, 16)), jnp.float32)
    fn = jax.jit(lambda p, xx: st.predict(p, xx, precision=precision))

    t_full = time_call(fn, params, x).median_ms
    print(f"full {'x'.join(map(str, units))} ({precision}): {t_full:.3f} ms")
    ratios = []
    for r in ranks:
        t_red = time_call(fn, st.make_reduced_model(smodel, rank=r), x).median_ms
        ratios.append(t_red / t_full)
        print(f"r={r:3d}: reduced {t_red:.3f} ms  ratio {ratios[-1]:.3f}")

    name = f"timing_plot{'_wide' if args.wide else ''}{'_fast' if args.fast else ''}.png"
    path = os.path.join(args.plots, name)
    plot_timing_curve(ranks, ratios, xlabel=f"kept rank r (n={units[0]})", savepath=path)
    print(f"wrote {path}  (reference band: 1.31-1.39 — never below 1)")


if __name__ == "__main__":
    main()
