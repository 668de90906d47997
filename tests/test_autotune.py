"""bench.autotune: measured-best impl selection + persistent cache.

Device time needs the GPU (bench.devtime raises elsewhere), so these CPU
tests inject a timer: the selection, failure isolation and caching logic
is the same whatever the clock."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import svd_lstm_tpu.bench.autotune as at
from svd_lstm_tpu.api import predict
from svd_lstm_tpu.models.lstm import init_stacked_lstm


def wall_timer(fn, *args, repeats=1):
    """Host-clock stand-in for bench.devtime.device_time_ms."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) * 1e3 + 1e-6


@pytest.fixture()
def model_x():
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
    x = jax.random.normal(jax.random.PRNGKey(1), (12, 4))
    return params, x


def test_candidates_follow_api_rules(model_x):
    params, x = model_x
    assert at.candidates(params, x) == ["scan", "fused"]
    wide = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(256,))
    assert at.candidates(wide, x) == ["scan"]  # wider than the kernel takes
    # 100 units: past the exact kernel's 64, within the TF32 kernel's 128
    mid = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(100,))
    assert at.candidates(mid, x) == ["scan"]
    assert at.candidates(mid, x, "fast") == ["scan", "fused"]
    xb = x[None]
    # batched: 'auto' IS the scan in every mode — measuring both would
    # pick a winner between identical code paths by noise
    for prec in ("exact", "high", "fast"):
        assert at.candidates(params, xb, prec) == ["scan"]


def test_autotune_survives_kernel_failures_and_picks_scan(model_x):
    """A candidate that fails is recorded in ``failed``, not raised, and
    the winner is the fastest of the survivors."""
    params, x = model_x
    times = iter([1.0, 2.0])

    def timer(fn, *args, repeats=1):
        jax.block_until_ready(fn(*args))
        return next(times)

    r = at.autotune(params, x, impls=["scan", "bogus", "fused"], timer=timer)
    assert r.table == {"scan": 1.0, "fused": 2.0}
    assert r.impl == "scan" and r.ms == 1.0
    assert set(r.failed) == {"bogus"} and "unknown impl" in r.failed["bogus"]


def test_cache_key_distinguishes(model_x):
    params, x = model_x
    other = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 6))
    k1 = at.cache_key(params, x, "exact")
    assert k1 == at.cache_key(params, x, "exact")
    assert k1 != at.cache_key(other, x, "exact")
    assert k1 != at.cache_key(params, x[:6], "exact")
    assert k1 != at.cache_key(params, x, "fast")
    # a bf16 input times differently (single-pass dots) — own cache entry
    assert k1 != at.cache_key(params, x.astype(jnp.bfloat16), "exact")
    # ...and so does a bf16-cast MODEL (same shapes, different pass count)
    from svd_lstm_tpu.utils.precision import cast_params

    assert k1 != at.cache_key(cast_params(params, jnp.bfloat16), x, "exact")


def test_cache_key_distinguishes_rank_permutations():
    """Split reduced models whose per-gate ranks are permutations of each
    other have identical total weight counts but different kernel shapes —
    they must not share a cache entry."""
    from svd_lstm_tpu.models.lstm import DenseParams
    from svd_lstm_tpu.models.reduced import ReducedLayerParams, ReducedModelParams

    d, n = 4, 8

    def mk(ranks):
        layer = ReducedLayerParams(
            wB=tuple(jnp.zeros((d, r)) for r in ranks),
            wC=tuple(jnp.zeros((r, n - r)) for r in ranks),
            uB=tuple(jnp.zeros((n, r)) for r in ranks),
            uC=tuple(jnp.zeros((r, n - r)) for r in ranks),
            b=jnp.zeros(4 * n),
        )
        return ReducedModelParams(
            layers=(layer,), head=DenseParams(w=jnp.zeros((n, 1)), b=jnp.zeros(1))
        )

    ra, rb = mk((2, 6, 4, 4)), mk((4, 4, 6, 2))
    assert ra.layers[0].weight_count() == rb.layers[0].weight_count()
    x = jax.random.normal(jax.random.PRNGKey(1), (12, d))
    assert at.cache_key(ra, x, "exact") != at.cache_key(rb, x, "exact")


def test_tuned_impl_caches_to_disk_and_memory(model_x, tmp_path, monkeypatch):
    params, x = model_x
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_MEM_CACHE", {})

    impl = at.tuned_impl(params, x, cache_path=cache, timer=wall_timer)
    assert impl in ("scan", "fused")
    data = json.load(open(cache))
    assert list(data.values()) == [impl]

    # second call must not re-measure: poison autotune
    def boom(*a, **k):
        raise AssertionError("re-measured despite cache")

    monkeypatch.setattr(at, "autotune", boom)
    assert at.tuned_impl(params, x, cache_path=cache) == impl
    # disk-only hit (fresh memory cache) also avoids re-measuring
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    assert at.tuned_impl(params, x, cache_path=cache) == impl


def test_predict_tuned_matches_predict(model_x, tmp_path, monkeypatch):
    params, x = model_x
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    y = at.predict_tuned(params, x, cache_path=str(tmp_path / "c.json"),
                         timer=wall_timer)
    # either winner computes the same model (kernel vs scan: f32 roundoff)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(predict(params, x, impl="scan")), atol=1e-5
    )


# ------------------------------------------------------------- training --


def _train_xy(B=8, T=4, d=4):
    x = jax.random.normal(jax.random.PRNGKey(2), (B, T, d))
    y = jax.random.normal(jax.random.PRNGKey(3), (B,))
    return x, y


def test_autotune_train_dense_measures_all_regimes(model_x):
    """On CPU every regime runs (the kernel in interpret mode), the winner
    is a relaxed regime, and f32_scan is context-only."""
    params, _ = model_x
    x, y = _train_xy()
    r = at.autotune_train(params, x, y, repeats=1, timer=wall_timer)
    assert set(r.table) == {"f32_scan", "tf32_scan", "bf16_scan", "fused_kernel"}
    assert (r.matmul_precision, r.recurrence_kernel) in {
        ("tensorfloat32", False), ("bfloat16", False), ("tensorfloat32", True)
    }
    assert r.ms == min(v for k, v in r.table.items() if k != "f32_scan")


def test_autotune_train_singular_uses_masked_step(model_x):
    """The singular family measures the σ-masked Hoyer fine-tune step —
    the optimizer must accept the singular pytree without error."""
    from svd_lstm_tpu.factor.svd import make_singular_model

    params, _ = model_x
    sp = make_singular_model(params, merged_kernel=False)
    x, y = _train_xy()
    r = at.autotune_train(sp, x, y, repeats=1, timer=wall_timer)
    assert "bf16_scan" in r.table and r.ms > 0


def test_autotune_train_conv_hybrid_measures_kernel():
    """Conv hybrids route through the recurrence kernel pair
    (ops/conv_train.py), so the fused_kernel regime is MEASURED — no
    family records 'failed' for it."""
    from svd_lstm_tpu.models.conv import init_conv_lstm

    hybrid = init_conv_lstm(
        jax.random.PRNGKey(0), in_channels=4, filters=6, kernel_size=3, units=(6,)
    )
    x, y = _train_xy()
    r = at.autotune_train(hybrid, x, y, repeats=1, timer=wall_timer)
    assert "fused_kernel" in r.table
    assert "fused_kernel" not in r.failed


def test_tuned_train_flags_cache_roundtrip(model_x, tmp_path, monkeypatch):
    params, _ = model_x
    x, y = _train_xy()
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    prec, kernel = at.tuned_train_flags(params, x, y, cache_path=cache,
                                        timer=wall_timer)
    assert prec in ("tensorfloat32", "bfloat16") and isinstance(kernel, bool)
    data = json.load(open(cache))
    assert len(data) == 1

    def boom(*a, **k):
        raise AssertionError("re-measured despite cache")

    monkeypatch.setattr(at, "autotune_train", boom)
    flags = (prec, kernel)
    assert at.tuned_train_flags(params, x, y, cache_path=cache) == flags
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    assert at.tuned_train_flags(params, x, y, cache_path=cache) == flags


# ----------------------------------------------- auto-dispatch consult --
# predict(impl='auto') consults the autotune cache so one `tune` run
# redirects every later auto-dispatch on the same device.


@pytest.fixture()
def clean_cache(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    monkeypatch.setattr(at, "_DISK_MEMO", {})
    monkeypatch.setattr(at, "default_cache_path", lambda: cache)
    return cache


def test_cached_impl_redirects_predict_auto(model_x, clean_cache, monkeypatch):
    """A seeded device-keyed winner redirects predict(impl='auto') to the
    measured path instead of the rule (which on CPU would run the scan for
    this narrow batch-1 model)."""
    import svd_lstm_tpu.ops.gpu_recurrence as gr

    params, x = model_x
    at.store_tuned(at.cache_key(params, x, "exact"), "fused")

    hits = {"n": 0}
    orig = gr.stack_forward

    def spy(p, xx, **kw):
        hits["n"] += 1
        return orig(p, xx, **kw)

    monkeypatch.setattr(gr, "stack_forward", spy)
    y = predict(params, x, impl="auto")
    assert hits["n"] == 1, "cached winner not dispatched"
    y_scan = predict(params, x, impl="scan")
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_scan), atol=1e-5)

    # consult_cache=False bypasses the lookup (autotune measures with it
    # off so an entry cannot redirect the 'auto' candidate mid-measure)
    predict(params, x, impl="auto", consult_cache=False)
    assert hits["n"] == 1


def test_cached_impl_reads_disk_never_measures(model_x, clean_cache, monkeypatch):
    params, x = model_x
    at.store_tuned(at.cache_key(params, x, "exact"), "fused")
    monkeypatch.setattr(at, "_MEM_CACHE", {})  # force the disk layer

    def boom(*a, **k):
        raise AssertionError("cached_impl measured")

    monkeypatch.setattr(at, "autotune", boom)
    assert at.cached_impl(params, x, "exact") == "fused"
    # a never-tuned shape returns None (no measurement, no exception)
    assert at.cached_impl(params, x[:6], "exact") is None


def test_stale_cache_entry_ignored(clean_cache):
    """A cached winner that is invalid for the input (here 'fused' for a
    wide model — its n<=128 rule) is ignored, not raised: predict falls
    back to the rule."""
    wide = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(256,))
    x = jax.random.normal(jax.random.PRNGKey(1), (12, 4))
    at.store_tuned(at.cache_key(wide, x, "exact"), "fused")
    y = predict(wide, x, impl="auto")  # would raise if 'fused' dispatched
    y_scan = predict(wide, x, impl="scan")
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_scan), atol=1e-5)


def test_cached_train_flags_readonly(model_x, clean_cache, monkeypatch):
    params, _ = model_x
    x, _y = _train_xy()
    assert at.cached_train_flags(params, x) is None
    at.store_tuned(at.train_cache_key(params, x), "bfloat16|1")
    monkeypatch.setattr(at, "_MEM_CACHE", {})  # force the disk layer
    assert at.cached_train_flags(params, x) == ("bfloat16", True)
    # an older entry's trailing layout field is ignored
    at.store_tuned(at.train_cache_key(params, x), "tensorfloat32|0|1")
    assert at.cached_train_flags(params, x) == ("tensorfloat32", False)


def test_store_tuned_populates_memo(model_x, clean_cache, monkeypatch):
    """The CLI's post-measurement store must hit the in-process memo too
    (a disk-only write would make a same-process tuned_train_flags re-read
    disk instead of the memo)."""
    params, x = model_x
    key = at.cache_key(params, x, "exact")
    at.store_tuned(key, "scan")
    assert at._MEM_CACHE[key] == "scan"
    data = json.load(open(clean_cache))
    assert data[key] == "scan"


# ------------------------------------------------- fit auto_flags consult --
# `tune --train` writes cached_train_flags, and TrainConfig.auto_flags
# makes fit/finetune consult it — tune once, train measured-best
# thereafter (symmetric with predict(impl='auto')).


def _tiny_train_setup():
    from svd_lstm_tpu.config import TrainConfig

    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
    X = np.random.default_rng(0).normal(size=(1, 64, 4)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    cfg = TrainConfig(
        num_windows=8, window_len=16, batch_size=4, epochs=1, auto_flags=True
    )
    return params, X, y, cfg


def _spy_resolved_cfg(monkeypatch):
    import svd_lstm_tpu.train.loop as loop

    seen = {}
    orig = loop.resolve_train_apply_fn

    def spy(cfg, apply_fn):
        seen["cfg"] = cfg
        return orig(cfg, apply_fn)

    monkeypatch.setattr(loop, "resolve_train_apply_fn", spy)
    return seen


def test_fit_consults_cached_train_flags(clean_cache, monkeypatch):
    """A seeded cache entry for the production window-batch shape
    (batch_size, window_len, d) redirects fit's training regime to the
    measured-best (matmul_precision, recurrence_kernel)."""
    from svd_lstm_tpu.train.loop import fit

    params, X, y, cfg = _tiny_train_setup()
    probe = np.empty((cfg.batch_size, cfg.window_len, 4), dtype=np.float32)
    at.store_tuned(
        at.train_cache_key(params, probe),
        at.encode_train_flags("bfloat16", True),
    )
    seen = _spy_resolved_cfg(monkeypatch)
    res = fit(params, X, y, cfg=cfg)
    assert len(res.history) == 1
    got = seen["cfg"]
    assert (got.matmul_precision, got.recurrence_kernel) == ("bfloat16", True)


def test_fit_auto_flags_miss_keeps_config(clean_cache, monkeypatch):
    """Cache miss: fit trains with the caller's flags unchanged and never
    measures (consult is read-only)."""
    from svd_lstm_tpu.train.loop import fit

    params, X, y, cfg = _tiny_train_setup()

    def boom(*a, **k):
        raise AssertionError("auto_flags measured on a miss")

    monkeypatch.setattr(at, "autotune_train", boom)
    seen = _spy_resolved_cfg(monkeypatch)
    fit(params, X, y, cfg=cfg)
    got = seen["cfg"]
    assert (got.matmul_precision, got.recurrence_kernel) == ("float32", False)


def test_finetune_consults_cached_train_flags(clean_cache, monkeypatch):
    """The σ fine-tune goes through the same consult (finetune -> fit):
    a singular-family cache entry flips its training regime too."""
    from svd_lstm_tpu.config import FactorConfig
    from svd_lstm_tpu.factor.svd import make_singular_model
    from svd_lstm_tpu.train.finetune import finetune

    params, X, y, cfg = _tiny_train_setup()
    sp = make_singular_model(params, merged_kernel=False)
    probe = np.empty((cfg.batch_size, cfg.window_len, 4), dtype=np.float32)
    at.store_tuned(
        at.train_cache_key(sp, probe),
        at.encode_train_flags("tensorfloat32", True),
    )
    seen = _spy_resolved_cfg(monkeypatch)
    finetune(sp, X, y, factor_cfg=FactorConfig(), train_cfg=cfg)
    got = seen["cfg"]
    assert (got.matmul_precision, got.recurrence_kernel) == ("tensorfloat32", True)
