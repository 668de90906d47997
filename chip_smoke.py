"""Smoke run of the SVD-LSTM main path on one GPU, in one process.

    python chip_smoke.py            # phases 1-7 on one card
    python chip_smoke.py --four     # only the four-card phases, on 4 cards

Phases, one line each (more lines for tables):

1. device   — JAX's devices, and the card's name and power limit;
2. compile  — the recurrence kernels compiled at real widths, checked once
              against the scan, and the 4×40 train step's memory analysis;
3. inference at the reference scale — the shipped 40-unit checkpoint,
   factorized and truncated at r=25, batch-1 T=6656 through ``predict``;
4. wide inference — the shipped 3×512 checkpoint, merged r=24, batch-1,
   and batched B=256 T=128 in every precision mode;
5. training — ``train.fit`` on synthetic DROPBEAR windows, kernel gradients
   against scan autodiff, one fine-tune and one recovery step;
6. timings — the kernel against the XLA scan at the shapes of PERF.md;
7. the ``gpu``-marked tests, run in this process.

Every comparison is against the ``models/`` lax.scan reference under
``jax.default_matmul_precision("highest")`` and prints its error beside
its tolerance. The last line of stdout is one JSON object; it is printed
only when every phase passed. Off the GPU, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The shapes every phase runs at (``Sizes()`` is the real run)."""

    T: int = 6656            # batch-1 whole run (the reference benchmark)
    train_T: int = 200       # BPTT window (reference train_full_model_v4)
    train_B: int = 32        # reference batch
    train_B_big: int = 512
    wide_B: int = 128
    batched: tuple = (256, 128)
    kernel_wide_B: int = 512  # the 128-unit compile check
    repeats: int = 5


# Tolerances, each with its reason. Exact mode runs IEEE f32 everywhere, so
# kernel and scan differ only in summation order (and, for the factored
# families, one reconstruction rounding per weight), amplified along the
# 6656-step chain: relative 1e-4. TF32 keeps 10 mantissa bits (~1e-3 per
# product): relative 1e-2. bf16 keeps 7 bits (~4e-3 per product, through
# three 512-wide layers): relative 5e-2. The merged r=24 truncation of the
# 3x512 model has an ill-conditioned C = V1^-1 V2, so its two exact f32
# forms (two-step and dense-reconstructed) differ by rounding amplified by
# cond(V1): relative 1e-2.
# Data-parallel training against one device: the same f32 steps with the
# gradient mean taken in another order, compounded over adam steps:
# relative 1e-3.
TOL = {"exact": 1e-4, "tf32": 1e-2, "bf16": 5e-2, "wide_reduced": 1e-2, "dp": 1e-3}


class Report:
    """Prints phase lines; timing lines carry the card and its power limit."""

    def __init__(self, card: str):
        self.card = card

    def line(self, *parts):
        print(" ".join(str(p) for p in parts), flush=True)

    def check(self, name, got, ref, tol):
        import numpy as np

        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: shape {got.shape} vs {ref.shape} or non-finite")
        diff = got - ref
        max_abs = float(np.max(np.abs(diff)))
        rel = float(np.linalg.norm(diff) / max(np.linalg.norm(ref), 1e-30))
        ok = rel <= tol
        self.line(f"  check {name}: max_abs {max_abs:.3e} rel {rel:.3e} "
                  f"(tol rel {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: rel {rel:.3e} > {tol:.0e}")
        return rel

    def time(self, name, fn, *args, repeats=5):
        from svd_lstm_tpu.bench.timing import time_call

        t = time_call(fn, *args, repeats=repeats)
        self.line(f"  time {name}: {t.median_ms:.3f} ms median of {repeats} "
                  f"(set-up incl. compile {t.setup_s:.2f} s) [{self.card}]")
        return t


def _card() -> str:
    """``name, power.limit`` from nvidia-smi, in a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _highest():
    import jax

    return jax.default_matmul_precision("highest")


def _scan_rec(xp, U):
    """The lax.scan recurrence (the kernel's reference), h_seq (T, B, n)."""
    import jax
    import jax.numpy as jnp

    from svd_lstm_tpu.models.lstm import gate_update

    B, n = xp.shape[1], U.shape[0]

    def step(hc, x):
        h, c = gate_update(x + hc[0] @ U, hc[1])
        return (h, c), h

    zero = jnp.zeros((B, n), jnp.float32)
    return jax.lax.scan(step, (zero, zero), xp)[1]


def _train_step(apply_fn, opt, prec):
    import jax
    import jax.numpy as jnp
    import optax

    def loss_fn(p, x, y):
        return jnp.mean((apply_fn(p, x, return_sequences=False)[..., 0] - y) ** 2)

    @jax.jit
    def step(p, s, x, y):
        with jax.default_matmul_precision(prec):
            loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    return step


# ------------------------------------------------------------------ phases --


def phase_compile(rep: Report, sz: Sizes):
    """Each kernel compiled at its real widths, checked once against scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from svd_lstm_tpu.models.lstm import init_stacked_lstm
    from svd_lstm_tpu.ops import gpu_recurrence as gr

    rng = np.random.default_rng(0)
    for n, B, T, prec, tol in (
        (40, 1, sz.T, "highest", TOL["exact"]),
        (40, sz.train_B, sz.train_T, "highest", TOL["exact"]),
        (40, sz.train_B, sz.train_T, "default", TOL["tf32"]),
        (128, sz.kernel_wide_B, sz.train_T, "default", TOL["tf32"]),
    ):
        xp = jnp.asarray(rng.normal(size=(T, B, 4 * n)), jnp.float32)
        U = jnp.asarray(rng.normal(size=(n, 4 * n)) / np.sqrt(n), jnp.float32)
        cot = jnp.asarray(rng.normal(size=(T, B, n)), jnp.float32)
        t0 = time.perf_counter()
        fwd = jax.jit(lambda a, u, p=prec: gr.lstm_recurrence_fwd(a, u, p)[0]).lower(xp, U).compile()
        grad = jax.jit(jax.grad(
            lambda a, u, p=prec: jnp.sum(gr.lstm_recurrence(a, u, p) * cot), argnums=(0, 1)
        )).lower(xp, U).compile()
        rep.line(f"  compiled fwd+bwd n={n} B={B} T={T} {prec} in "
                 f"{time.perf_counter() - t0:.1f} s")
        with _highest():
            h_ref = jax.jit(_scan_rec)(xp, U)
            g_ref = jax.jit(jax.grad(lambda a, u: jnp.sum(_scan_rec(a, u) * cot),
                                     argnums=(0, 1)))(xp, U)
        g = grad(xp, U)
        rep.check(f"fwd n={n} B={B} {prec}", fwd(xp, U), h_ref, tol)
        rep.check(f"dxp n={n} B={B} {prec}", g[0], g_ref[0], tol)
        rep.check(f"dU n={n} B={B} {prec}", g[1], g_ref[1], tol)

    params = init_stacked_lstm(jax.random.PRNGKey(0), 16, (40,) * 4)
    opt = optax.adam(1e-3)
    x = jnp.zeros((sz.train_B, sz.train_T, 16), jnp.float32)
    y = jnp.zeros((sz.train_B,), jnp.float32)
    step = _train_step(gr.stacked_lstm_apply_fast_train, opt, "tensorfloat32")
    compiled = step.lower(params, opt.init(params), x, y).compile()
    rep.line(f"  4x40 train step (B={sz.train_B}, T={sz.train_T}) memory: "
             f"{compiled.memory_analysis()}")


def _factorize(params, merged, rank):
    import svd_lstm_tpu as st

    smodel = st.make_singular_model(params, merged_kernel=merged)
    return smodel, st.make_reduced_model(smodel, rank=rank)


def _inference_checks(rep, label, params, merged, rank, x1, fast_tol, repeats):
    """predict (auto) for the dense, singular and reduced families against
    their scans at "highest", exact and fast."""
    import jax

    import svd_lstm_tpu as st

    smodel, rmodel = _factorize(params, merged, rank)
    refs = {
        "dense": (params, st.stacked_lstm_apply),
        "singular": (smodel, st.singular_lstm_apply),
        "reduced": (rmodel, st.reduced_lstm_apply),
    }
    for fam, (p, apply) in refs.items():
        with _highest():
            ref = jax.jit(lambda q, xx, f=apply: f(q, xx[None], return_sequences=True)[0])(p, x1)
        for prec, tol in (("exact", TOL["exact"]), ("fast", fast_tol)):
            fn = jax.jit(lambda q, xx, pr=prec: st.predict(q, xx, precision=pr))
            rep.check(f"{label} {fam} {prec}", fn(p, x1), ref, tol)
            rep.time(f"{label} predict {fam} {prec} T={x1.shape[0]}", fn, p, x1,
                     repeats=repeats)
    return smodel, rmodel


def phase_reference_inference(rep: Report, sz: Sizes):
    import jax.numpy as jnp
    import numpy as np

    import svd_lstm_tpu as st

    params = st.load_params(os.path.join(REPO, "model_saves/pretrained_sequential.npz"))
    rep.line(f"  checkpoint pretrained_sequential: units "
             f"{[l.units for l in params.layers]} d={params.layers[0].input_dim}")
    x1 = jnp.asarray(np.random.default_rng(1).normal(size=(sz.T, 16)), jnp.float32)
    _inference_checks(rep, "ref-scale", params, False, 25, x1, TOL["tf32"], sz.repeats)


def phase_wide_inference(rep: Report, sz: Sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import svd_lstm_tpu as st
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent

    params = st.load_params(os.path.join(REPO, "model_saves/pretrained_3x512_n1.5.npz"))
    rng = np.random.default_rng(2)
    x1 = jnp.asarray(rng.normal(size=(sz.T, 16)), jnp.float32)
    _, rmodel = _factorize(params, True, 24)
    for name, p, apply, tol in (
        ("full", params, st.stacked_lstm_apply, TOL["exact"]),
        ("reduced", rmodel, reduced_lstm_apply, TOL["wide_reduced"]),
    ):
        with _highest():
            ref = jax.jit(lambda q, xx: apply(q, xx[None], return_sequences=True)[0])(p, x1)
        fn = jax.jit(lambda q, xx: st.predict(q, xx))
        rep.check(f"wide batch-1 {name} exact", fn(p, x1), ref, tol)
        rep.time(f"wide batch-1 predict {name} exact T={sz.T}", fn, p, x1, repeats=3)
    # both XLA forms of the reduced wide model (predict takes the faster)
    for name, f in (
        ("dense-reconstructed scan", reduced_forward_dense_recurrent),
        ("two-step scan", reduced_lstm_apply),
    ):
        fn = jax.jit(lambda q, xx, f=f: f(q, xx[None], return_sequences=True)[0])
        rep.time(f"wide batch-1 reduced {name} T={sz.T}", fn, rmodel, x1, repeats=3)

    B, T = sz.batched
    X = jnp.asarray(rng.normal(size=(B, T, 16)), jnp.float32)
    with _highest():
        ref = jax.jit(lambda q, xx: st.stacked_lstm_apply(q, xx, return_sequences=True))(params, X)
    for prec, tol in (("exact", TOL["exact"]), ("high", TOL["tf32"]), ("fast", TOL["bf16"])):
        fn = jax.jit(lambda q, xx, pr=prec: st.predict(q, xx, precision=pr))
        rep.check(f"batched B={B} T={T} {prec}", fn(params, X), ref, tol)
        rep.time(f"batched predict B={B} T={T} {prec}", fn, params, X, repeats=sz.repeats)


def _windows(sz: Sizes, B: int, steps: int, seed: int):
    """``steps`` batches of B synthetic DROPBEAR windows (numpy, host)."""
    from svd_lstm_tpu.data.batcher import split_train_random
    from svd_lstm_tpu.data.dropbear import preprocess_raw
    from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw

    ds = preprocess_raw(synthetic_dropbear_raw(seed=seed))
    return split_train_random(ds.X_train, ds.y_train, B * steps, sz.train_T, seed=seed)


def phase_training(rep: Report, sz: Sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import svd_lstm_tpu as st
    from svd_lstm_tpu.config import FactorConfig, TrainConfig
    from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
    from svd_lstm_tpu.ops import gpu_recurrence as gr
    from svd_lstm_tpu.train.finetune import finetune, finetune_reduced
    from svd_lstm_tpu.train.loop import fit

    def run_fit(label, units, B, kernel, epochs=3, steps=4):
        Xw, yw = _windows(sz, B, steps, seed=3)
        params = init_stacked_lstm(jax.random.PRNGKey(3), 16, units)
        cfg = TrainConfig(num_windows=B * steps, window_len=sz.train_T, batch_size=B,
                          epochs=epochs, learning_rate=3e-3, recurrence_kernel=kernel)
        t0 = time.perf_counter()
        res = fit(params, None, None, cfg=cfg, windows=(Xw, yw))
        wall = time.perf_counter() - t0
        h = res.history
        ok = len(h) == epochs and np.isfinite(h).all() and h[-1] < h[0]
        rep.line(f"  fit {label} B={B} T={sz.train_T} recurrence_kernel={kernel}: "
                 f"epoch losses {[round(float(v), 5) for v in h]} "
                 f"{'falls' if ok else 'FAIL'} ({wall:.1f} s for {epochs * steps} "
                 f"steps incl. compile) [{rep.card}]")
        if not ok:
            raise AssertionError(f"fit {label}: loss not finite and falling: {h}")
        return res.params

    run_fit("4x40", (40,) * 4, sz.train_B, False)
    trained = run_fit("4x40", (40,) * 4, sz.train_B, True)
    run_fit("3x512", (512,) * 3, sz.wide_B, False)

    # kernel gradients against scan autodiff at "highest"
    Xw, yw = _windows(sz, sz.train_B, 1, seed=4)
    x, y = jnp.asarray(Xw), jnp.asarray(yw)
    params = init_stacked_lstm(jax.random.PRNGKey(4), 16, (40,) * 4)

    def grads(apply):
        def loss(p):
            return jnp.mean((apply(p, x, return_sequences=False)[..., 0] - y) ** 2)

        return jax.jit(jax.grad(loss))(params)

    with _highest():
        g_ref = grads(stacked_lstm_apply)
    for prec, tol in (("highest", TOL["exact"]), ("default", TOL["tf32"])):
        g = grads(lambda p, xx, return_sequences, pr=prec:
                  gr.stacked_lstm_apply_fast_train(p, xx, return_sequences, precision=pr))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g),
                                jax.tree.leaves(g_ref)):
            rep.check(f"grad {prec} {jax.tree_util.keystr(path)}", a, b, tol)

    # one fine-tune step (Hoyer, sigma-only) and one recovery step, kernel on
    Xw, yw = _windows(sz, sz.train_B, 1, seed=5)
    cfg = TrainConfig(num_windows=sz.train_B, window_len=sz.train_T, batch_size=sz.train_B,
                      epochs=1, recurrence_kernel=True)
    smodel = st.make_singular_model(trained, merged_kernel=False)
    ft = finetune(smodel, None, None, factor_cfg=FactorConfig(hoyer=0.01), train_cfg=cfg,
                  windows=(Xw, yw))
    rmodel = st.make_reduced_model(ft.params, rank=25)
    rec = finetune_reduced(rmodel, None, None, train_cfg=cfg, windows=(Xw, yw))
    for name, res in (("finetune (Hoyer, sigma-only)", ft), ("recovery r=25", rec)):
        if not np.isfinite(res.history).all():
            raise AssertionError(f"{name}: non-finite loss {res.history}")
        rep.line(f"  {name} step through the kernel: loss {res.history[0]:.5f}")


def phase_timings(rep: Report, sz: Sizes):
    """Kernel vs the XLA scan, end to end, at the shapes of PERF.md."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import svd_lstm_tpu as st
    from svd_lstm_tpu.bench.devtime import device_time_ms
    from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
    from svd_lstm_tpu.ops import gpu_recurrence as gr

    params = init_stacked_lstm(jax.random.PRNGKey(0), 16, (40,) * 4)
    _, rmodel = _factorize(params, False, 25)
    x1 = jnp.asarray(np.random.default_rng(6).normal(size=(sz.T, 16)), jnp.float32)
    scan = jax.jit(lambda p, xx: stacked_lstm_apply(p, xx[None], return_sequences=True)[0])
    for label, p in (("4x40 dense", params), ("4x40 reduced r=25 split", rmodel)):
        for prec in ("exact", "fast"):
            kern = jax.jit(lambda q, xx, pr=prec: st.predict(q, xx, impl="fused", precision=pr))
            rep.time(f"kernel {label} batch-1 {prec} T={sz.T}", kern, p, x1, repeats=sz.repeats)
        xla = jax.jit(lambda q, xx: st.predict(q, xx, impl="scan"))
        rep.time(f"xla scan {label} batch-1 exact T={sz.T}", xla, p, x1, repeats=sz.repeats)
        with jax.default_matmul_precision("tensorfloat32"):
            xla_tf32 = jax.jit(lambda q, xx: st.predict(q, xx, impl="scan"))
            rep.time(f"xla scan {label} batch-1 tf32 T={sz.T}", xla_tf32, p, x1,
                     repeats=sz.repeats)
    dev_k = device_time_ms(jax.jit(lambda q, xx: st.predict(q, xx, impl="fused")), params, x1)
    dev_s = device_time_ms(scan, params, x1)
    rep.line(f"  device time (kernel sum, profiler) 4x40 dense batch-1 exact: kernel "
             f"{dev_k:.3f} ms, xla scan {dev_s:.3f} ms [{rep.card}]")

    opt = optax.adam(1e-3)
    for B in (sz.train_B, sz.train_B_big):
        x = jnp.asarray(np.random.default_rng(7).normal(size=(B, sz.train_T, 16)), jnp.float32)
        y = jnp.zeros((B,), jnp.float32)
        s0 = opt.init(params)
        for label, apply, prec in (
            ("xla scan f32", stacked_lstm_apply, "float32"),
            ("xla scan tf32", stacked_lstm_apply, "tensorfloat32"),
            ("kernel tf32", gr.stacked_lstm_apply_fast_train, "tensorfloat32"),
        ):
            rep.time(f"train step 4x40 B={B} T={sz.train_T} {label}",
                     _train_step(apply, opt, prec), params, s0, x, y, repeats=sz.repeats)
    wide = init_stacked_lstm(jax.random.PRNGKey(1), 16, (512,) * 3)
    x = jnp.asarray(np.random.default_rng(8).normal(size=(sz.wide_B, sz.train_T, 16)),
                    jnp.float32)
    y = jnp.zeros((sz.wide_B,), jnp.float32)
    for label, prec in (("xla scan f32", "float32"), ("xla scan tf32", "tensorfloat32")):
        rep.time(f"train step 3x512 B={sz.wide_B} T={sz.train_T} {label}",
                 _train_step(stacked_lstm_apply, opt, prec), wide, opt.init(wide), x, y,
                 repeats=sz.repeats)


def phase_gpu_tests(rep: Report):
    import pytest

    os.environ["SVD_LSTM_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests", "test_gpu_compiled.py")])
    rep.line(f"  gpu tests: pytest exit {int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {int(rc)})")


def phase_four(rep: Report, devices, sz: Sizes):
    """The multi-device paths, each against its unsharded counterpart."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import __graft_entry__ as graft
    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
    from svd_lstm_tpu.parallel.fit import fit_dp
    from svd_lstm_tpu.parallel.mesh import make_mesh
    from svd_lstm_tpu.parallel.pipeline import make_pipeline_inference
    from svd_lstm_tpu.train.loop import fit

    meshes = graft.multichip_checks(devices)
    rep.line(f"  multichip checks passed on meshes {meshes}")

    n = len(devices)
    mesh = make_mesh(dp=n, tp=1, devices=devices)
    Xw, yw = _windows(sz, sz.train_B, 4, seed=9)
    params = init_stacked_lstm(jax.random.PRNGKey(9), 16, (40,) * 4)
    cfg = TrainConfig(num_windows=sz.train_B * 4, window_len=sz.train_T,
                      batch_size=sz.train_B, epochs=2)
    r_dp = fit_dp(params, None, None, mesh, cfg=cfg, windows=(Xw, yw))
    r_1 = fit(params, None, None, cfg=cfg, windows=(Xw, yw))
    rep.check(f"fit_dp over {n} devices vs fit: epoch losses", r_dp.history, r_1.history,
              TOL["dp"])

    pp = make_pipeline_inference(make_mesh(dp=1, tp=n, devices=devices), n_stages=n)
    x1 = jnp.asarray(np.random.default_rng(10).normal(size=(1, sz.T, 16)), jnp.float32)
    out = pp(params, x1)
    rep.line(f"  pp wavefront output spans {len(out.sharding.device_set)} devices")
    with _highest():
        ref = jax.jit(lambda p, xx: stacked_lstm_apply(p, xx, return_sequences=True))(params, x1)
    rep.check(f"pp wavefront {n} stages 4x40 T={sz.T}", out, ref, TOL["exact"])
    rep.time(f"pp wavefront {n} stages 4x40 T={sz.T}", pp, params, x1, repeats=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases on jax.devices()[:4]")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from svd_lstm_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs the GPU; JAX found {devices}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs 4 GPUs; JAX found {devices}", file=sys.stderr)
        return 2
    rep = Report(_card())
    rep.line(f"phase 1 device: {devices} kind {dev.device_kind!r} count {len(devices)}")
    rep.line(f"card: {rep.card}")
    sz = Sizes()
    if args.four:
        rep.line("phase four-card: sharded train, fit_dp, dp inference, pp wavefront")
        phase_four(rep, devices[:4], sz)
    else:
        for title, fn in (
            ("phase 2 compile", lambda: phase_compile(rep, sz)),
            ("phase 3 inference, reference scale", lambda: phase_reference_inference(rep, sz)),
            ("phase 4 inference, wide", lambda: phase_wide_inference(rep, sz)),
            ("phase 5 training", lambda: phase_training(rep, sz)),
            ("phase 6 timings", lambda: phase_timings(rep, sz)),
            ("phase 7 gpu tests", lambda: phase_gpu_tests(rep)),
        ):
            t0 = time.perf_counter()
            rep.line(title)
            fn()
            rep.line(f"  {title}: ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
