"""Benchmark: SVD-compressed vs full LSTM inference and the training step,
timed on the GPU through the normal entry points (``predict`` and the
``TrainConfig`` training swaps).

Protocol parity with the reference (time the whole-run predict, full vs
reduced — code/svd_acceleration_v3.py:147-152, plots/timing_plot.png). The
reference's Python/Keras reduced model ran 1.31-1.39× SLOWER than its full
model at every rank (slide 15).

Rows:

* **reference_scale**: 4×40 split r=25, batch-1, T=6656, exact and fast;
* **wide**: 3×512 merged r=24, batch-1, T=6656, exact;
* **batched**: 3×512, B=256, T=128, exact / high / fast;
* **train**: the full step (value_and_grad + adam) at T=200 — 4×40 at
  B=32 and B=512, 3×512 at B=128 — on the f32 scan, the TF32 scan and
  ``TrainConfig(recurrence_kernel=True)``.

Every time is a host-clock median after a warm-up call ended by
``block_until_ready`` (``bench.timing``); the warm-up, compilation
included, is reported as set-up. Prints ONE JSON line on stdout, naming
the device kind, count and power limit; diagnostics go to stderr. Exits
non-zero, printing no result, when JAX finds no GPU.
"""

import json
import subprocess
import sys

import numpy as np

REFERENCE_RATIO = 1.31  # timing(reduced)/timing(full), reference slide 15
T = 6656
UNITS = (40, 40, 40, 40)
INPUT_DIM = 16
RANK = 25
WIDE_UNITS = (512, 512, 512)
WIDE_RANK = 24
BATCHED_B, BATCHED_T = 256, 128
TRAIN_T = 200


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit() -> str:
    """``name, power.limit`` of the card, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _row(timings: dict) -> dict:
    return {
        k: {"ms": round(t.median_ms, 4), "setup_s": round(t.setup_s, 3)}
        for k, t in timings.items()
    }


def bench_inference(jax, jnp, st, time_call):
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    rng = np.random.default_rng(0)
    x1 = jnp.asarray(rng.normal(size=(T, INPUT_DIM)), jnp.float32)
    out = {}
    for name, units, rank, merged in (
        ("reference_scale", UNITS, RANK, False),
        ("wide", WIDE_UNITS, WIDE_RANK, True),
    ):
        params = init_stacked_lstm(jax.random.PRNGKey(0), INPUT_DIM, units)
        rmodel = st.make_reduced_model(
            st.make_singular_model(params, merged_kernel=merged), rank=rank
        )
        t = {}
        for prec in ("exact", "fast"):
            fn = jax.jit(lambda p, xx, prec=prec: st.predict(p, xx, precision=prec))
            t[f"full_{prec}"] = time_call(fn, params, x1)
            t[f"reduced_{prec}"] = time_call(fn, rmodel, x1)
        row = _row(t)
        row["ratio_exact"] = round(t["reduced_exact"].median_ms / t["full_exact"].median_ms, 4)
        row["ratio_fast"] = round(t["reduced_fast"].median_ms / t["full_fast"].median_ms, 4)
        log(f"[{name}] {row}")
        out[name] = row
    return out


def bench_batched(jax, jnp, st, time_call):
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.normal(size=(BATCHED_B, BATCHED_T, INPUT_DIM)), jnp.float32)
    params = init_stacked_lstm(jax.random.PRNGKey(2), INPUT_DIM, WIDE_UNITS)
    t = {
        prec: time_call(jax.jit(lambda p, xx, prec=prec: st.predict(p, xx, precision=prec)),
                        params, X)
        for prec in ("exact", "high", "fast")
    }
    row = _row(t)
    log(f"[batched] {row}")
    return row


def bench_train(jax, jnp, time_call):
    import optax

    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
    from svd_lstm_tpu.train.loop import resolve_train_apply_fn

    rng = np.random.default_rng(3)
    opt = optax.adam(1e-3)

    def mk_step(apply_fn, prec):
        def loss_fn(p, xx, yy):
            pred = apply_fn(p, xx, return_sequences=False)[..., 0]
            return jnp.mean((pred - yy) ** 2)

        @jax.jit
        def step(p, s, xx, yy):
            with jax.default_matmul_precision(prec):
                l, g = jax.value_and_grad(loss_fn)(p, xx, yy)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s, l

        return step

    kernel_apply, _ = resolve_train_apply_fn(
        TrainConfig(recurrence_kernel=True), stacked_lstm_apply
    )
    out = {}
    for name, units, B in (("4x40_B32", UNITS, 32), ("4x40_B512", UNITS, 512),
                           ("3x512_B128", WIDE_UNITS, 128)):
        params = init_stacked_lstm(jax.random.PRNGKey(3), INPUT_DIM, units)
        s0 = opt.init(params)
        x = jnp.asarray(rng.normal(size=(B, TRAIN_T, INPUT_DIM)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(B,)), jnp.float32)
        t = {
            "f32_scan": time_call(mk_step(stacked_lstm_apply, "float32"), params, s0, x, y),
            "tf32_scan": time_call(mk_step(stacked_lstm_apply, "tensorfloat32"),
                                   params, s0, x, y),
            "recurrence_kernel": time_call(mk_step(kernel_apply, "tensorfloat32"),
                                           params, s0, x, y),
        }
        row = _row(t)
        log(f"[train {name}] {row}")
        out[name] = row
    return out


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        log(f"bench.py measures the GPU; JAX found {jax.devices()}")
        sys.exit(2)
    import jax.numpy as jnp

    import svd_lstm_tpu as st
    from svd_lstm_tpu.bench.timing import time_call
    from svd_lstm_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    card = power_limit()
    log(f"devices: {jax.devices()}  card: {card}")
    inference = bench_inference(jax, jnp, st, time_call)
    result = {
        "metric": "whole_run_latency_ratio_reduced_over_full",
        "value": inference["wide"]["ratio_exact"],
        "unit": "ratio (batch-1 host-clock median, 3x512 merged r=24, T=6656)",
        "vs_baseline": round(REFERENCE_RATIO / inference["wide"]["ratio_exact"], 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        **inference,
        "batched": bench_batched(jax, jnp, st, time_call),
        "train": bench_train(jax, jnp, time_call),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
