"""Command-line entry: ``python -m svd_lstm_tpu <command> [args]``.

Commands map to the workflow scripts in examples/ (the reference ran bare
scripts top-to-bottom; here each stage is a subcommand over the library):

    train      — train the full dense regressor (examples/train_full_model)
    compress   — factorize → Hoyer fine-tune → truncate → benchmark
    sweep      — rank-reduction sweep, RMSE curve + gif
    rank-rmse  — reproduce the published 4×30/k=15 rank-RMSE configuration
    timing     — timing-vs-rank curves
    freq       — toy sine-series task
    batched    — batched multi-sequence inference demo
    seq-train  — parallel→sequential weight-merge experiment (sequentialize)
    distributed— dp training pipeline over a device mesh (fit_dp/finetune_dp)
    bench      — headline benchmark JSON line
    native-bench — C++ streaming runtime timing vs the CSV/int8 exports
    export     — checkpoint → deployment artifacts (per-gate CSV, JSON,
                 optional int8-quantized npz): the reference's LabVIEW
                 export surface (code/load_preprocess.py:80-165) as a command
    trace      — capture a jax.profiler trace of whole-run inference and
                 print the per-op device-time breakdown (bench.trace); the
                 diagnostic upgrade of the reference's perf_counter timing
                 (code/svd_acceleration_v3.py:147-152)
    tune       — measure every valid predict() impl for a checkpoint on
                 this device, print the table, memoize the winner
                 (bench.autotune / predict_tuned's cache)
    stream     — real-time frame-at-a-time inference over a CSV/stdin frame
                 stream from any deployment artifact (checkpoint, CSV
                 export dir, int8 .bin), optionally through the native C++
                 runtime: the reference's LabVIEW consumer loop
                 (code/old_versions/svd_classes.py:104-119) as a pipe-able
                 command
"""

import runpy
import os
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMANDS = {
    "train": "examples/train_full_model.py",
    "compress": "examples/svd_acceleration.py",
    "sweep": "examples/rank_sweep.py",
    "rank-rmse": "examples/rank_rmse_published.py",
    "timing": "examples/timing_curves.py",
    "freq": "examples/frequency_prediction.py",
    "batched": "examples/batched_inference.py",
    "seq-train": "examples/sequentialize_train.py",
    "distributed": "examples/distributed_training.py",
    "bench": "bench.py",
    "native-bench": "scripts/bench_native.py",
}


def _load_checkpoint_f32(path):
    """``load_params`` + dequantize: an int8-quantized npz checkpoint
    (``export --int8``'s model_int8.npz, QuantizedTensor leaves) loads as
    the f32 model it encodes, so every CLI consumer (stream/tune/trace/
    export) just works on it; plain checkpoints pass through unchanged
    (dequantize_params is an identity on non-quantized leaves)."""
    from svd_lstm_tpu.io.checkpoint import load_params
    from svd_lstm_tpu.utils.quantize import dequantize_params

    return dequantize_params(load_params(path))


def _export(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu export",
        description="Export a dense-model checkpoint to deployment artifacts.",
    )
    ap.add_argument("checkpoint", help=".npz checkpoint or Orbax directory (io.checkpoint)")
    ap.add_argument("outdir", help="output directory")
    ap.add_argument("--json", action="store_true", help="also dump model_weights.json")
    ap.add_argument("--int8", action="store_true", help="also dump an int8-quantized npz")
    args = ap.parse_args(argv)

    from svd_lstm_tpu.io.checkpoint import save_params
    from svd_lstm_tpu.io.csv_weights import (
        save_model_weights_as_csv,
        save_model_weights_as_json,
    )

    params = _load_checkpoint_f32(args.checkpoint)
    os.makedirs(args.outdir, exist_ok=True)
    # family dispatch: reduced checkpoints (incl. the conv-reduced hybrid)
    # export two-step factors; dense (incl. conv-dense) per-gate blocks
    inner = params.inner if hasattr(params, "inner") else params
    if hasattr(inner.layers[0], "ws"):
        raise SystemExit(
            "singular (factorized) checkpoints have no deployment export: "
            "collapse to dense first (factor.singular_to_dense / "
            "conv_singular_to_dense) or truncate (make_reduced_model)"
        )
    is_reduced = hasattr(inner.layers[0], "wB")
    if is_reduced:
        from svd_lstm_tpu.io.native import save_reduced_weights_as_csv

        save_reduced_weights_as_csv(params, args.outdir)
        print(f"two-step factor CSVs -> {args.outdir}/")
    else:
        save_model_weights_as_csv(params, args.outdir)
        print(f"per-gate CSVs -> {args.outdir}/")
    if args.json:
        if is_reduced or hasattr(params, "conv"):
            raise SystemExit(
                "--json covers the reference's dense JSON dump "
                "(load_preprocess.py:80-90) only; export a dense "
                "(non-conv) checkpoint or drop --json"
            )
        path = os.path.join(args.outdir, "model_weights.json")
        save_model_weights_as_json(params, path)
        print(f"JSON dump -> {path}")
    if args.int8:
        from svd_lstm_tpu.utils.quantize import param_bytes, quantize_params

        q = quantize_params(params)
        path = os.path.join(args.outdir, "model_int8.npz")
        save_params(path, q)
        print(
            f"int8 checkpoint -> {path} "
            f"({param_bytes(q)} vs {param_bytes(params)} bytes on device)"
        )
        from svd_lstm_tpu.io.int8_export import save_model_int8_bin

        bin_path = os.path.join(args.outdir, "model_int8.bin")
        nbytes = save_model_int8_bin(params, bin_path)
        print(
            f"int8 native artifact -> {bin_path} ({nbytes} bytes; "
            "loads via NativeModel.from_int8 / svdlstm_load_int8)"
        )


def _trace(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu trace",
        description="Capture a profiler trace of whole-run inference and "
        "print the per-op device-time breakdown.",
    )
    ap.add_argument("outdir", help="trace output directory (TensorBoard logdir)")
    ap.add_argument(
        "--checkpoint", default=None, help="model checkpoint (default: random 4x40)"
    )
    ap.add_argument("--steps", type=int, default=2048, help="run length T")
    ap.add_argument(
        "--impl", default="auto", choices=("auto", "scan", "fused"),
        help="predict impl",
    )
    ap.add_argument(
        "--precision", default="exact", choices=("exact", "high", "fast")
    )
    ap.add_argument("--top", type=int, default=15, help="rows in the op table")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from svd_lstm_tpu.api import predict
    from svd_lstm_tpu.bench.trace import format_breakdown, summarize

    if args.checkpoint:
        params = _load_checkpoint_f32(args.checkpoint)
    else:
        from svd_lstm_tpu.models.lstm import init_stacked_lstm

        params = init_stacked_lstm(jax.random.key(0))
    from svd_lstm_tpu.api import model_input_dim

    d = model_input_dim(params)  # family-aware (conv hybrids: c_in)
    x = jax.random.normal(jax.random.key(1), (args.steps, d), jnp.float32)
    fn = jax.jit(lambda p, xx: predict(p, xx, impl=args.impl, precision=args.precision))
    s = summarize(fn, params, x, out_dir=args.outdir, top=args.top)
    print(f"device total: {s['device_ms']:.3f} ms  (T={args.steps}, impl={args.impl}, "
          f"precision={args.precision})")
    print(format_breakdown(s["ops"], total_ms=s["device_ms"]))
    print(f"\ntrace -> {args.outdir}  (view: tensorboard --logdir {args.outdir}, "
          "profile plugin; or load the *.trace.json.gz in ui.perfetto.dev)")


def _tune(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu tune",
        description="Measure every valid predict() implementation for a "
        "model/input shape on THIS device and print the table + winner "
        "(bench.autotune; the winner memoizes to the persistent cache "
        "predict_tuned serves from).",
    )
    ap.add_argument(
        "--checkpoint", default=None, help="model checkpoint (default: random 4x40)"
    )
    ap.add_argument(
        "--steps", type=int, default=None,
        help="run length T (default: 2048 for inference tuning, 200 — the "
        "reference's window length — for --train; a None default so an "
        "explicit --steps 2048 --train is honored rather than remapped)",
    )
    ap.add_argument("--batch", type=int, default=0, help="0 = batch-1 (T, d) input")
    ap.add_argument(
        "--precision", default="exact", choices=("exact", "high", "fast")
    )
    ap.add_argument("--repeats", type=int, default=2, help="timing repeats per impl")
    ap.add_argument(
        "--no-cache", action="store_true", help="measure only; skip the disk cache"
    )
    ap.add_argument(
        "--train", action="store_true",
        help="tune the TRAINING step instead of inference: measure "
        "f32/tf32/bf16 scans and the recurrence kernel pair (full "
        "value_and_grad+adam step, family-aware: σ-masked Hoyer step for "
        "singular checkpoints) and report the winning TrainConfig "
        "(matmul_precision, recurrence_kernel) flags; --batch/--steps set "
        "the window batch (default B=32, T=200 — the reference's regime)",
    )
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from svd_lstm_tpu.bench import autotune as at

    if args.checkpoint:
        params = _load_checkpoint_f32(args.checkpoint)
    else:
        from svd_lstm_tpu.models.lstm import init_stacked_lstm

        params = init_stacked_lstm(jax.random.key(0))
    from svd_lstm_tpu.api import model_input_dim

    d = model_input_dim(params)  # family-aware (conv hybrids: c_in)
    dev = jax.devices()[0]
    if args.train:
        B = args.batch or 32
        T = args.steps if args.steps is not None else 200
        x = jax.random.normal(jax.random.key(1), (B, T, d), jnp.float32)
        y = jax.random.normal(jax.random.key(2), (B,), jnp.float32)
        r = at.autotune_train(params, x, y, repeats=args.repeats)
        print(f"device: {dev.platform}:{dev.device_kind}   windows (B={B}, "
              f"T={T}, d={d})  full train step incl. optimizer")
        for name, ms in sorted(r.table.items(), key=lambda kv: kv[1]):
            if name == "f32_scan":
                mark = "  (exact regime — context, never tuned)"
            elif ms == r.ms:
                mark = " <- winner"
            else:
                mark = ""
            print(f"  {name:<13} {ms:10.3f} ms/step{mark}")
        for name, err in r.failed.items():
            print(f"  {name:<13} SKIPPED: {err.splitlines()[0][:90]}")
        print(
            "TrainConfig flags: "
            f"matmul_precision={r.matmul_precision!r}, "
            f"recurrence_kernel={r.recurrence_kernel}"
        )
        if not args.no_cache:
            cache = at.store_tuned(
                at.train_cache_key(params, x),
                at.encode_train_flags(r.matmul_precision, r.recurrence_kernel),
            )
            print(f"cached -> {cache}")
        return
    T = args.steps if args.steps is not None else 2048
    shape = (args.batch, T, d) if args.batch else (T, d)
    x = jax.random.normal(jax.random.key(1), shape, jnp.float32)
    r = at.autotune(params, x, precision=args.precision, repeats=args.repeats)
    print(f"device: {dev.platform}:{dev.device_kind}   input {shape}  "
          f"precision={args.precision}")
    for impl, ms in sorted(r.table.items(), key=lambda kv: kv[1]):
        mark = " <- winner" if impl == r.impl else ""
        print(f"  {impl:<8} {ms:10.3f} ms{mark}")
    for impl, err in r.failed.items():
        print(f"  {impl:<8} FAILED: {err.splitlines()[0][:90]}")
    if not args.no_cache:
        cache = at.store_tuned(at.cache_key(params, x, args.precision), r.impl)
        print(f"cached -> {cache}")


def _stream(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu stream",
        description="Frame-at-a-time streaming inference from a deployment "
        "artifact: each input line is one frame (comma/space-separated "
        "floats), each output line one prediction, flushed per frame — "
        "pipe-able into a downstream consumer. Runs on CPU (this is the "
        "host/embedded deployment story; use predict for the GPU path).",
    )
    ap.add_argument(
        "artifact",
        help=".npz/Orbax checkpoint (dense, singular or reduced params), a "
        "CSV weight-export directory, or an int8 .bin native artifact",
    )
    ap.add_argument(
        "--input", default="-",
        help="frame CSV path, or '-' for stdin (default)",
    )
    ap.add_argument(
        "--output", default="-",
        help="prediction output path, or '-' for stdout (default)",
    )
    ap.add_argument(
        "--native", action="store_true",
        help="run through the C++ runtime (io.native). Implied for .bin "
        "artifacts and for reduced-form CSV export dirs (which only the "
        "native runtime consumes); a checkpoint is exported to a temporary "
        "CSV dir first",
    )
    ap.add_argument(
        "--force-two-step", action="store_true",
        help="native path: skip the load-time execution dispatch and force "
        "the raw two-step on every reduced side (benchmarking aid)",
    )
    ap.add_argument(
        "--stats", action="store_true",
        help="print per-frame host-latency percentiles to stderr at EOF",
    )
    args = ap.parse_args(argv)

    import time

    import numpy as np

    # Pin JAX to CPU before ANY branch may initialize a backend: the native
    # checkpoint path below calls load_params -> jnp.asarray, which would
    # otherwise lazily open the GPU (reserving most of its memory) just to
    # re-export CSVs, and fail beside a process that already holds the
    # card. Importing jax does not initialize a backend; the config update
    # keeps every later lazy init on CPU, matching this command's "Runs on
    # CPU" contract.
    import jax

    jax.config.update("jax_platforms", "cpu")

    is_bin = args.artifact.endswith(".bin")
    is_dir_export = os.path.isdir(args.artifact) and os.path.exists(
        os.path.join(args.artifact, "dense_top")
    )
    reduced_csv = False
    if is_dir_export:
        from svd_lstm_tpu.io.csv_weights import list_layer_dirs

        dirs = list_layer_dirs(args.artifact)
        reduced_csv = bool(dirs) and not os.path.exists(
            os.path.join(args.artifact, dirs[0], "Wi.csv")
        )
    use_native = args.native or is_bin or reduced_csv

    tmpdir = None
    if use_native:
        from svd_lstm_tpu.io.native import NativeModel

        if is_bin:
            nm = NativeModel.from_int8(
                args.artifact, force_two_step=args.force_two_step
            )
        elif is_dir_export:
            nm = NativeModel.from_export_dir(
                args.artifact, force_two_step=args.force_two_step
            )
        else:
            # checkpoint -> temp CSV export -> native load
            import tempfile

            params = _load_checkpoint_f32(args.artifact)
            tmpdir = tempfile.TemporaryDirectory(prefix="svdlstm_stream_")
            # conv hybrids: the exporters accept the wrapper types directly;
            # family detection runs on the inner LSTM stack
            inner = params.inner if hasattr(params, "inner") else params
            if hasattr(inner.layers[0], "wB"):
                # split AND merged reduced checkpoints both export (the
                # native runtime's 'r' and 'm' layer kinds, round 3)
                from svd_lstm_tpu.io.native import save_reduced_weights_as_csv

                save_reduced_weights_as_csv(params, tmpdir.name)
            elif hasattr(inner.layers[0], "ws"):
                raise SystemExit(
                    "--native cannot run a singular (factorized) checkpoint: "
                    "the native runtime consumes dense or two-step reduced "
                    "exports. Truncate first (make_reduced_model) or drop "
                    "--native for the JAX streaming path."
                )
            else:
                from svd_lstm_tpu.io.csv_weights import save_model_weights_as_csv

                save_model_weights_as_csv(params, tmpdir.name)
            nm = NativeModel.from_export_dir(
                tmpdir.name, force_two_step=args.force_two_step
            )

        in_dim = nm.input_dim

        def step(frame):
            return [nm.step(frame)]
    else:
        import jax.numpy as jnp

        from svd_lstm_tpu.models.streaming import make_stream_fn

        if is_dir_export:
            from svd_lstm_tpu.io.csv_weights import load_model_from_csv

            params = load_model_from_csv(args.artifact)
        else:
            params = _load_checkpoint_f32(args.artifact)
        from svd_lstm_tpu.api import model_input_dim

        in_dim = model_input_dim(params)  # family-aware (conv hybrids: c_in)
        step_fn, state = make_stream_fn(params)
        state_box = [state]

        def step(frame):
            y, state_box[0] = step_fn(
                state_box[0], jnp.asarray(frame, jnp.float32)[None, :]
            )
            return np.asarray(y).ravel().tolist()

    fin = sys.stdin if args.input == "-" else open(args.input)
    fout = sys.stdout if args.output == "-" else open(args.output, "w")
    lat_ms = []
    n = 0
    try:
        for line in fin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            frame = np.array(
                [float(v) for v in line.replace(",", " ").split()],
                dtype=np.float32,
            )
            if frame.size != in_dim:
                raise SystemExit(
                    f"input line {n + 1}: frame has {frame.size} values; "
                    f"the model expects {in_dim} per frame"
                )
            if args.stats:
                t0 = time.perf_counter()
                y = step(frame)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
            else:  # no unbounded latency buffer on long-running pipes
                y = step(frame)
            fout.write(",".join(f"{v:.8g}" for v in y) + "\n")
            fout.flush()
            n += 1
    finally:
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
        if tmpdir is not None:
            tmpdir.cleanup()
    if args.stats and lat_ms:
        lat = np.asarray(lat_ms[1:] or lat_ms)  # drop the compile/warmup frame
        print(
            f"{n} frames  engine={'native' if use_native else 'jax-cpu'}  "
            f"per-frame host latency p50 {np.percentile(lat, 50)*1e3:.1f} us  "
            f"p99 {np.percentile(lat, 99)*1e3:.1f} us  "
            f"max {lat.max()*1e3:.1f} us (first frame excluded)",
            file=sys.stderr,
        )


def main():
    from svd_lstm_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) >= 2 and sys.argv[1] == "export":
        _export(sys.argv[2:])
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "trace":
        _trace(sys.argv[2:])
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "tune":
        _tune(sys.argv[2:])
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "stream":
        _stream(sys.argv[2:])
        return
    if len(sys.argv) < 2 or sys.argv[1] not in _COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(
            [*_COMMANDS, "export", "trace", "tune", "stream"]
        ))
        raise SystemExit(2)
    script = os.path.join(_HERE, _COMMANDS[sys.argv[1]])
    sys.argv = [script] + sys.argv[2:]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
