"""Measured-best implementation selection with a persistent cache.

``api.predict(impl="auto")`` routes by a fixed rule (the api module
docstring). An unusual model shape or a future compiler can move the
crossover, so this module re-derives the choice *on the device actually
present* — it times every implementation that is valid for the given
model/input (``bench.devtime`` device time) and returns the winner,
optionally memoized to a JSON cache keyed by model family, per-layer leaf
shapes, parameter and input dtypes, input shape, precision, and backend
device kind (not just platform — crossovers move between devices).

The reference had no analog — it hardcoded one execution path and
published the resulting 1.31–1.39× loss (plots/timing_plot.png). Here
"which path wins" is a measurement, not an assumption.

Usage::

    from svd_lstm_tpu.bench.autotune import autotune, predict_tuned

    choice = autotune(params, x)            # TuneResult: winner + table
    y = predict_tuned(params, x)            # measure once, then cached

Every measuring function takes ``timer(fn, *args, repeats=...) -> ms``,
``bench.devtime.device_time_ms`` by default (which needs the GPU).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from svd_lstm_tpu.bench.devtime import device_time_ms
from svd_lstm_tpu.models.lstm import StackedLSTMParams
from svd_lstm_tpu.models.reduced import ReducedModelParams
from svd_lstm_tpu.models.singular import SingularModelParams


class TuneResult(NamedTuple):
    impl: str                      # winning impl for api.predict
    ms: float                      # its measured device time
    table: dict[str, float]        # impl -> ms for every valid candidate
    failed: dict[str, str]         # impl -> error for candidates that died


def _family(params) -> str:
    if isinstance(params, StackedLSTMParams):
        return "dense"
    if isinstance(params, SingularModelParams):
        return "singular"
    if isinstance(params, ReducedModelParams):
        return "reduced"
    if hasattr(params, "conv"):  # conv hybrids wrap an inner family
        inner = (
            params.inner
            if hasattr(params, "inner")
            else StackedLSTMParams(layers=params.layers, head=params.head)
        )
        return "conv+" + _family(inner)
    raise TypeError(f"unknown model params: {type(params)}")


def _dims(params) -> list:
    """Per-layer (units, every leaf's shape) plus the head's leaf shapes —
    units pins the kernel family's width rules; the full shape list pins
    input dim, per-gate ranks, split vs merged AND the head width exactly.
    (A summed weight count would collide on per-gate rank *permutations*,
    which change kernel padding; omitting the head would serve one model's
    winner to another whose (T, n) @ (n, out) head matmul moves the
    crossover.)"""
    shapes = lambda node: [  # noqa: E731
        tuple(int(s) for s in x.shape) for x in jax.tree_util.tree_leaves(node)
    ]
    if hasattr(params, "conv"):  # conv hybrids: conv kernel shape + inner dims
        inner = (
            params.inner
            if hasattr(params, "inner")
            else StackedLSTMParams(layers=params.layers, head=params.head)
        )
        return [("conv", shapes(params.conv))] + _dims(inner)
    return [(int(l.units), shapes(l)) for l in params.layers] + [shapes(params.head)]


def cache_key(params, x, precision: str) -> str:
    """Stable string key: family, per-layer leaf shapes, parameter dtype,
    input shape and dtype, precision, backend device kind. ``device_kind``,
    not just platform — crossover points move between device models, so
    a cached winner must not outlive the device it was measured on. Parameter dtype is keyed for the same
    reason as input dtype: a bf16-cast model changes matmul pass counts
    and can move the crossovers."""
    dev = jax.devices()[0]
    return json.dumps(
        {
            "family": _family(params),
            "dims": _dims(params),
            "pdtype": sorted(
                {str(jnp.result_type(x)) for x in jax.tree_util.tree_leaves(params)}
            ),
            "x": tuple(int(s) for s in x.shape),
            "dtype": str(jnp.result_type(x)),
            "precision": precision,
            "device": f"{dev.platform}:{dev.device_kind}",
        },
        sort_keys=True,
    )


def candidates(params, x, precision: str = "exact") -> list[str]:
    """Implementations with distinct execution paths for this
    (model, input, precision) — delegates to ``api.valid_impls`` so the
    candidate set lives next to predict()'s dispatch and cannot drift
    (e.g. batched 'auto' aliases 'scan'; measuring both would pick a
    winner by noise)."""
    from svd_lstm_tpu.api import valid_impls

    return valid_impls(params, x, precision)


def autotune(
    params,
    x,
    precision: str = "exact",
    impls: Sequence[str] | None = None,
    repeats: int = 2,
    timer=None,
) -> TuneResult:
    """Time every valid ``api.predict`` implementation and pick the winner.

    Candidates that fail to compile/execute are recorded in ``failed`` and
    skipped. ``impls`` overrides the candidate list.
    """
    from svd_lstm_tpu.api import predict

    timer = timer or device_time_ms

    # Measure in the caller's dtype — a bf16 input times differently
    # (other matmul precision) and has its own cache entry.
    x = jnp.asarray(x)
    table: dict[str, float] = {}
    failed: dict[str, str] = {}
    for impl in impls if impls is not None else candidates(params, x, precision):
        # consult_cache off: a pre-existing cache entry must not redirect
        # the 'auto' candidate while it is itself being measured
        fn = jax.jit(
            lambda p, xx, i=impl: predict(
                p, xx, impl=i, precision=precision, consult_cache=False
            )
        )
        try:
            table[impl] = timer(fn, params, x, repeats=repeats)
        except Exception as e:  # noqa: BLE001 — per-candidate isolation
            failed[impl] = f"{type(e).__name__}: {e}"
    if not table:
        raise RuntimeError(f"every candidate failed: {failed}")
    best = min(table, key=table.get)
    return TuneResult(impl=best, ms=table[best], table=table, failed=failed)


# ---------------------------------------------------------------- cache --

_MEM_CACHE: dict[str, str] = {}
# mtime-keyed snapshot of the disk cache so read-only lookups on the
# predict hot path (api.predict impl='auto' consults the cache at trace
# time) don't re-read the file per call
_DISK_MEMO: dict[str, tuple[float, dict]] = {}


def default_cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "svd_lstm_tpu", "autotune.json")


def _load_disk(path: str) -> dict[str, str]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk(path: str, key: str, impl: str) -> None:
    # The cache is one shared file (~/.cache): hold an exclusive lock
    # across the read-modify-write so two concurrent processes tuning
    # different models don't drop each other's (expensively measured)
    # entries. os.replace keeps readers crash-safe either way.
    import fcntl

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        data = _load_disk(path)
        data[key] = impl
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)


def _read_disk_cached(path: str) -> dict:
    """Disk cache contents, memoized on (path, mtime) — fresh writes (a
    concurrent ``tune`` run) invalidate the memo automatically."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    hit = _DISK_MEMO.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    data = _load_disk(path)
    _DISK_MEMO[path] = (mtime, data)
    return data


def _cached_value(key: str, cache_path: str | None) -> str | None:
    """Read-only lookup (memory, then disk) — NEVER measures."""
    if cache_path is None:
        cache_path = default_cache_path()
    val = _MEM_CACHE.get(key)
    if val is None and cache_path:
        val = _read_disk_cached(cache_path).get(key)
        if val is not None:
            _MEM_CACHE[key] = val
    return val


def cached_impl(
    params, x, precision: str = "exact", cache_path: str | None = None
) -> str | None:
    """The measured-best impl for this (model, input, precision, device)
    if one was ever tuned (``tune`` CLI / ``tuned_impl``), else None —
    the read-only lookup ``api.predict(impl="auto")`` consults so one
    ``tune`` run redirects every later auto-dispatch on the same device.
    Keys include the backend device kind, so a winner measured on one
    device model never leaks onto another (which keeps predict's rule)."""
    return _cached_value(cache_key(params, x, precision), cache_path)


def cached_train_flags(
    params, x, cache_path: str | None = None
) -> tuple[str, bool] | None:
    """The measured-best ``(matmul_precision, recurrence_kernel)``
    TrainConfig flags for this (model, window shape, device) if ever tuned
    (``tune --train`` / ``tuned_train_flags``), else None — the read-only
    training analog of :func:`cached_impl`."""
    val = _cached_value(train_cache_key(params, x), cache_path)
    if val is None:
        return None
    return _decode_train_flags(val)


def encode_train_flags(prec: str, kernel: bool) -> str:
    return f"{prec}|{int(kernel)}"


def _decode_train_flags(val: str) -> tuple[str, bool]:
    """Decode ``prec|kernel`` (a trailing field of older entries, whose
    layout option no longer exists, is ignored)."""
    parts = val.split("|")
    return parts[0], bool(int(parts[1]))


def store_tuned(key: str, value: str, cache_path: str | None = None) -> str:
    """Public cache write: populate the in-memory memo AND the disk layer
    (the CLI's post-measurement store; ``tuned_impl``/``tuned_train_flags``
    in the same process then serve the memo instead of re-reading disk).
    Pass ``cache_path=""`` to skip the disk layer. Returns the path used."""
    if cache_path is None:
        cache_path = default_cache_path()
    _MEM_CACHE[key] = value
    if cache_path:
        _store_disk(cache_path, key, value)
    return cache_path


def tuned_impl(
    params, x, precision: str = "exact", cache_path: str | None = None,
    timer=None,
) -> str:
    """Best impl for this (model, input, precision, platform) — measured
    once, then served from the in-memory + on-disk cache. Pass
    ``cache_path=""`` to disable the disk layer."""
    if cache_path is None:
        cache_path = default_cache_path()
    key = cache_key(params, x, precision)
    impl = _cached_value(key, cache_path)
    if impl is None:
        impl = autotune(params, x, precision=precision, timer=timer).impl
        if cache_path:
            _store_disk(cache_path, key, impl)
    _MEM_CACHE[key] = impl
    return impl


def predict_tuned(params, x, precision: str = "exact", cache_path: str | None = None,
                  timer=None):
    """``api.predict`` through the measured-best implementation."""
    from svd_lstm_tpu.api import predict

    return predict(
        params, x, impl=tuned_impl(params, x, precision, cache_path, timer),
        precision=precision,
    )


# ------------------------------------------------------------- training --


class TrainTuneResult(NamedTuple):
    matmul_precision: str          # winning TrainConfig.matmul_precision
    recurrence_kernel: bool        # winning TrainConfig.recurrence_kernel
    ms: float                      # its measured full-step device time
    table: dict[str, float]        # regime -> ms for every candidate
    failed: dict[str, str]         # regime -> error for candidates that died


# (name, TrainConfig.matmul_precision, TrainConfig.recurrence_kernel).
# f32_scan is the exact regime — measured for context, never the winner:
# exact training has exactly one implementation, so there is nothing to
# tune there. The relaxed regimes compete: the kernel pair (TF32 dots)
# takes the narrow stacks it supports (every family — dense, singular,
# reduced, conv hybrids); the TF32 and bf16 scans take the rest.
_TRAIN_REGIMES = (
    ("f32_scan", "float32", False),
    ("tf32_scan", "tensorfloat32", False),
    ("bf16_scan", "bfloat16", False),
    ("fused_kernel", "tensorfloat32", True),
)


def _train_apply_for(params):
    """Stock scan apply_fn for the model family (the same resolution
    fit/finetune perform), plus the family's loss extra + optimizer
    factory so the measured step is the step that family actually runs."""
    import optax

    from svd_lstm_tpu.models.lstm import stacked_lstm_apply

    fam = _family(params)
    if fam == "dense":
        return stacked_lstm_apply, None, lambda p: optax.adam(1e-3)
    if fam == "singular":
        from svd_lstm_tpu.config import FactorConfig
        from svd_lstm_tpu.models.singular import singular_lstm_apply
        from svd_lstm_tpu.train.finetune import (
            make_finetune_optimizer,
            regularization_loss,
        )

        fcfg = FactorConfig(hoyer=0.01)
        return (
            singular_lstm_apply,
            lambda p: regularization_loss(p, fcfg),
            lambda p: make_finetune_optimizer(p, fcfg),
        )
    if fam == "reduced":
        from svd_lstm_tpu.models.reduced import reduced_lstm_apply

        return reduced_lstm_apply, None, lambda p: optax.adam(1e-3)
    if fam.startswith("conv+"):
        from svd_lstm_tpu.train.finetune import reduced_apply_fn

        if fam == "conv+reduced":
            return reduced_apply_fn(params), None, lambda p: optax.adam(1e-3)
        if fam == "conv+singular":
            from svd_lstm_tpu.config import FactorConfig
            from svd_lstm_tpu.models.conv import conv_singular_apply
            from svd_lstm_tpu.train.finetune import (
                make_finetune_optimizer,
                regularization_loss,
            )

            fcfg = FactorConfig(hoyer=0.01)
            return (
                conv_singular_apply,
                lambda p: regularization_loss(p, fcfg),
                lambda p: make_finetune_optimizer(p, fcfg),
            )
        from svd_lstm_tpu.models.conv import conv_lstm_apply

        return conv_lstm_apply, None, lambda p: optax.adam(1e-3)
    raise TypeError(f"no training path for family {fam!r}")


def autotune_train(
    params, x, y, repeats: int = 2, include_exact: bool = True, timer=None
) -> TrainTuneResult:
    """Time the full training step (value_and_grad + optimizer update) for
    every training regime valid for this model and pick the fastest
    *relaxed* one as ``(matmul_precision, recurrence_kernel)`` TrainConfig
    flags — the training analog of ``autotune``/``predict(impl="auto")``.

    ``x``: a sample window batch (B, T, d); ``y``: (B,) labels — the
    measured step is shaped exactly like the production step, including
    the family's σ-mask optimizer and regularizer for singular models.
    The kernel regime is skipped (recorded in ``failed``) if the family
    resolution yields no kernel swap — measuring the identical scan twice
    would pick a winner by noise.
    """
    import optax

    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.train.loop import resolve_train_apply_fn

    timer = timer or device_time_ms
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    base_apply, loss_extra, make_opt = _train_apply_for(params)
    optimizer = make_opt(params)
    opt_state = optimizer.init(params)

    def mk_step(apply_fn, scope):
        def loss_fn(p, xx, yy):
            pred = apply_fn(p, xx, return_sequences=False)[..., 0]
            loss = jnp.mean(jnp.square(pred - yy))
            if loss_extra is not None:
                loss = loss + loss_extra(p)
            return loss

        @jax.jit
        def step(p, s, xx, yy):
            with jax.default_matmul_precision(scope):
                l, g = jax.value_and_grad(loss_fn)(p, xx, yy)
            u, s = optimizer.update(g, s, p)
            return optax.apply_updates(p, u), s, l

        return step

    table: dict[str, float] = {}
    failed: dict[str, str] = {}
    for name, prec, kernel in _TRAIN_REGIMES:
        if name == "f32_scan" and not include_exact:
            continue
        apply_fn = base_apply
        if kernel:
            apply_fn, using_kernel = resolve_train_apply_fn(
                TrainConfig(recurrence_kernel=True), base_apply
            )
            if not using_kernel:
                failed[name] = "no training kernel for this model family"
                continue
        try:
            table[name] = timer(
                mk_step(apply_fn, prec), params, opt_state, x, y, repeats=repeats
            )
        except Exception as e:  # noqa: BLE001 — per-candidate isolation
            failed[name] = f"{type(e).__name__}: {e}"
    relaxed = {k: v for k, v in table.items() if k != "f32_scan"}
    if not relaxed:
        raise RuntimeError(f"every relaxed training regime failed: {failed}")
    best = min(relaxed, key=relaxed.get)
    prec, kernel = {n: (p, k) for n, p, k in _TRAIN_REGIMES}[best]
    return TrainTuneResult(
        matmul_precision=prec,
        recurrence_kernel=kernel,
        ms=relaxed[best],
        table=table,
        failed=failed,
    )


def train_cache_key(params, x) -> str:
    """Training-regime cache key: like ``cache_key`` plus the train
    marker; precision is what's being tuned, so it is not in the key."""
    dev = jax.devices()[0]
    return json.dumps(
        {
            "train": True,
            "family": _family(params),
            "dims": _dims(params),
            # .shape directly when present (fit's auto_flags consult passes
            # a host-side shape probe — forcing it through jnp.asarray would
            # ship it to device just to read the shape)
            "x": tuple(
                int(s)
                for s in (x.shape if hasattr(x, "shape") else jnp.asarray(x).shape)
            ),
            "device": f"{dev.platform}:{dev.device_kind}",
        },
        sort_keys=True,
    )


def tuned_train_flags(
    params, x, y, cache_path: str | None = None, timer=None
) -> tuple[str, bool]:
    """Measured-best ``(matmul_precision, recurrence_kernel)`` TrainConfig
    flags for this (model, window shape, device) — measured once, then
    served from the same in-memory/disk cache as ``tuned_impl``. Apply as
    ``dataclasses.replace(cfg, matmul_precision=p, recurrence_kernel=k)``."""
    if cache_path is None:
        cache_path = default_cache_path()
    key = train_cache_key(params, x)
    val = _cached_value(key, cache_path)
    if val is None:
        r = autotune_train(params, x, y, include_exact=False, timer=timer)
        val = encode_train_flags(r.matmul_precision, r.recurrence_kernel)
        if cache_path:
            _store_disk(cache_path, key, val)
    _MEM_CACHE[key] = val
    return _decode_train_flags(val)
