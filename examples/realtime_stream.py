"""Real-time streaming deployment demo: the per-sample state-carrying loop.

The reference's deployment target is a batch-1, frame-at-a-time inference
loop feeding a LabVIEW/FPGA rig (reference
code/old_versions/svd_classes.py:104-119 — `multi_step_forward_pass` — and
the per-gate CSV export of code/load_preprocess.py:93-126 it consumed).
This demo walks that exact consumer role on the compressed model:

1. train-free setup: init a dense model, factorize, truncate to the exact
   two-step reduced form (the deployment artifact);
2. drive the JAX streaming API frame-by-frame (`models/streaming`):
   parity vs the whole-run scan, measured per-frame host latency for the
   jitted single step and the chunked `stream_many` dispatch;
3. export the per-gate CSVs and drive the native C++ runtime
   (`native/svdlstm_runtime.cpp`) over the same frames: parity vs JAX and
   per-frame latency — including what the load-time execution dispatch
   chose per layer (two-step where it pays, dense-reconstructed where it
   cannot).

Run:  python examples/realtime_stream.py [--quick] [--units 40,40 --rank 10]
CPU is the right backend here — this is the host/embedded consumer story,
not the GPU path (use bench.py / examples/timing_curves.py for that).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--units", default="40,40,40,40")
    ap.add_argument("--rank", type=int, default=25)
    ap.add_argument("--frames", type=int, default=0, help="0 = auto")
    args = ap.parse_args()

    # host demo: pin to CPU before jax initializes (same mechanism as tests)
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.models.streaming import (
        init_stream,
        make_stream_fn,
        stream_many,
    )

    units = tuple(int(u) for u in args.units.split(","))
    if args.quick:
        units = units[:2]
    d = 16
    T = args.frames or (256 if args.quick else 2048)

    dense = st.init_stacked_lstm(jax.random.PRNGKey(0), d, units)
    rmodel = st.make_reduced_model(
        st.make_singular_model(dense, merged_kernel=False), rank=args.rank
    )
    wc_full = sum(np.asarray(a).size for a in jax.tree.leaves(dense))
    wc_red = sum(np.asarray(a).size for a in jax.tree.leaves(rmodel))
    print(f"model {len(units)}x{units[0]} r={args.rank}: "
          f"{wc_full} -> {wc_red} weights ({wc_red / wc_full:.2f}x)")

    rng = np.random.default_rng(0)
    frames = rng.normal(size=(T, d)).astype(np.float32)

    # whole-run scan = the numerical oracle
    oracle = np.asarray(
        reduced_lstm_apply(rmodel, jnp.asarray(frames)[None])
    )[0, :, 0]

    # --- JAX streaming, frame at a time (jitted packed closure) ---------
    step_fn, state = make_stream_fn(rmodel)
    ys = np.empty(T, np.float32)
    y, state = step_fn(state, frames[:1])  # compile outside the timed loop
    t0 = time.perf_counter()
    state = init_stream(rmodel)
    for i in range(T):
        y, state = step_fn(state, frames[i : i + 1])
        ys[i] = float(y[0, 0])
    per_frame_us = (time.perf_counter() - t0) / T * 1e6
    err = float(np.max(np.abs(ys - oracle)))
    print(f"jax stream_step   : {per_frame_us:8.1f} us/frame   "
          f"max|err| {err:.2e}")
    assert err < 1e-4

    # --- JAX chunked streaming (one dispatch per chunk) -----------------
    chunk = 64
    many = jax.jit(stream_many)
    # compile every chunk shape the timed loop will see (incl. a partial
    # tail when T % chunk != 0) so XLA compiles stay outside the clock
    _ = many(rmodel, init_stream(rmodel), jnp.asarray(frames[None, :chunk]))
    if T % chunk:
        _ = many(rmodel, init_stream(rmodel),
                 jnp.asarray(frames[None, : T % chunk]))
    t0 = time.perf_counter()
    state = init_stream(rmodel)
    outs = []
    for i in range(0, T, chunk):
        yc, state = many(rmodel, state, jnp.asarray(frames[None, i : i + chunk]))
        outs.append(np.asarray(yc)[0, :, 0])
    per_frame_chunk_us = (time.perf_counter() - t0) / T * 1e6
    err_c = float(np.max(np.abs(np.concatenate(outs) - oracle)))
    print(f"jax stream_many/{chunk:<3}: {per_frame_chunk_us:8.1f} us/frame   "
          f"max|err| {err_c:.2e}")
    assert err_c < 1e-4

    # --- native C++ runtime (the LabVIEW-consumer role) -----------------
    try:
        from svd_lstm_tpu.io.native import (
            NativeModel,
            build_native,
            save_reduced_weights_as_csv,
        )

        build_native()
    except Exception as e:  # no toolchain on this box
        print(f"native runtime unavailable ({e}); done")
        return

    with tempfile.TemporaryDirectory() as tmp:
        save_reduced_weights_as_csv(rmodel, tmp)
        nm = NativeModel(
            tmp, [f"lstm_{i}" for i in range(len(units))], "r" * len(units)
        )
        for li in range(len(units)):
            info = nm.layer_info(li)
            print(f"  native layer {li}: w {'two-step' if info['w_reduced'] else 'dense'}"
                  f", u {'two-step' if info['u_reduced'] else 'dense'}")
        y_nat = nm.run(frames)  # warm (loads stay hot), then timed run
        nm.reset()
        t0 = time.perf_counter()
        y_nat = nm.run(frames)
        per_frame_nat_us = (time.perf_counter() - t0) / T * 1e6
        err_n = float(np.max(np.abs(y_nat - oracle)))
        print(f"native C++ step   : {per_frame_nat_us:8.1f} us/frame   "
              f"max|err| {err_n:.2e}")
        assert err_n < 1e-3

    print("realtime streaming demo OK")


if __name__ == "__main__":
    main()
