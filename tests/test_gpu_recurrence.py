"""The recurrence kernel pair (ops/gpu_recurrence.py) on the CPU, in
interpret mode, and the choices around it: the backend predicate, the
compile-cache location, gate padding, and which path ``predict`` and the
training swap take on a (patched) GPU platform.

Tolerances: on the CPU every dot is IEEE f32 whatever its precision flag,
so kernel and scan differ only in summation order: 2e-6 absolute on the
O(1) states of a 13-step run, 2e-5 on gradients summed over (T, B).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svd_lstm_tpu.models.lstm import gate_update, init_stacked_lstm
from svd_lstm_tpu.ops import gpu_recurrence as gr
from svd_lstm_tpu.utils import backend


def _scan_hc(xp, U):
    B, n = xp.shape[1], U.shape[0]

    def step(hc, x):
        h, c = gate_update(x + hc[0] @ U, hc[1])
        return (h, c), (h, c)

    zero = jnp.zeros((B, n), jnp.float32)
    return jax.lax.scan(step, (zero, zero), xp)[1]


def _case(n, B, T, seed=0):
    rng = np.random.default_rng(seed)
    xp = jnp.asarray(rng.normal(size=(T, B, 4 * n)), jnp.float32)
    U = jnp.asarray(rng.normal(size=(n, 4 * n)) / np.sqrt(n), jnp.float32)
    return xp, U


# ----------------------------------------------------------------- kernel --


@pytest.mark.parametrize("T", [1, 13])
@pytest.mark.parametrize("B", [1, 16, 37])
@pytest.mark.parametrize("n", [8, 40, 64, 100, 128])
def test_forward_matches_scan(n, B, T):
    xp, U = _case(n, B, T)
    h, c = gr.lstm_recurrence_fwd(xp, U)
    h_ref, c_ref = _scan_hc(xp, U)
    assert h.shape == (T, B, n) and c.shape == (T, B, n)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), atol=2e-6)
    np.testing.assert_allclose(np.asarray(c), np.asarray(c_ref), atol=2e-6)


@pytest.mark.parametrize("B", [1, 17, 37])   # 1, 2 and 3 batch tiles
@pytest.mark.parametrize("n", [8, 40])
def test_backward_matches_scan_autodiff(n, B):
    T = 7
    xp, U = _case(n, B, T, seed=1)
    cot = jnp.asarray(np.random.default_rng(2).normal(size=(T, B, n)), jnp.float32)
    h, c = gr.lstm_recurrence_fwd(xp, U)
    dxp, dU = gr.lstm_recurrence_bwd(xp, U, h, c, cot)
    g_xp, g_U = jax.grad(lambda a, u: jnp.sum(_scan_hc(a, u)[0] * cot), argnums=(0, 1))(xp, U)
    np.testing.assert_allclose(np.asarray(dxp), np.asarray(g_xp), atol=2e-5)
    np.testing.assert_allclose(np.asarray(dU), np.asarray(g_U), atol=2e-5)


@pytest.mark.parametrize(
    "n,G", [(1, 16), (8, 16), (16, 16), (17, 32), (40, 64), (64, 64), (100, 128), (128, 128)]
)
def test_gate_width_is_power_of_two_at_least_16(n, G):
    assert gr.gate_width(n) == G


@pytest.mark.parametrize("n,B", [(40, 3), (8, 1)])
def test_padded_lanes_and_rows_stay_zero(n, B):
    """Zero pre-activations keep h and c at exactly 0 in the padding: the
    padded gate columns and the pad rows of the last batch tile."""
    T = 5
    xp, U = _case(n, B, T, seed=3)
    G = gr.gate_width(n)
    Bp = 16
    h, c = gr.forward_padded(gr._pad_xp(xp, Bp, G), gr._pad_u(U, G), "highest")
    assert h.shape == (T, Bp, G)
    for a in (np.asarray(h), np.asarray(c)):
        assert not a[:, :, n:].any()      # padded lanes
        assert not a[:, B:, :].any()      # padded rows
    np.testing.assert_allclose(np.asarray(h)[:, :B, :n],
                               np.asarray(_scan_hc(xp, U)[0]), atol=2e-6)


def test_pad_xp_keeps_each_gate_in_its_block():
    n, G = 3, 16
    xp = jnp.arange(2 * 1 * 4 * n, dtype=jnp.float32).reshape(2, 1, 4 * n)
    p = np.asarray(gr._pad_xp(xp, 16, G))
    for g in range(4):
        np.testing.assert_array_equal(p[:, 0, g * G:g * G + n], np.asarray(xp)[:, 0, g * n:(g + 1) * n])
        assert not p[:, 0, g * G + n:(g + 1) * G].any()


@pytest.mark.parametrize("precision,limit", [("highest", 64), ("default", 128)])
def test_kernel_width_limit_per_precision(precision, limit):
    ok = init_stacked_lstm(jax.random.PRNGKey(0), 4, (8, limit))
    wide = init_stacked_lstm(jax.random.PRNGKey(0), 4, (limit + 1,))
    assert gr.kernel_takes(ok, precision)
    assert not gr.kernel_takes(wide, precision)
    with pytest.raises(ValueError, match="at most"):
        gr.stack_forward(wide, jnp.zeros((3, 4)), precision=precision)


def test_unknown_kernel_precision_raises():
    with pytest.raises(ValueError, match="unknown kernel precision"):
        gr.resolve_precision("bfloat16")


# -------------------------------------------------------- backend predicate --


def test_platform_is_cpu_here_and_interpret_follows():
    assert backend.platform() == "cpu"
    assert backend.interpret() is True


@pytest.mark.parametrize("name,expect", [("gpu", "gpu"), ("cpu", "cpu")])
def test_platform_accepts_gpu_and_cpu(monkeypatch, name, expect):
    monkeypatch.setattr(backend.jax, "devices", lambda: [SimpleNamespace(platform=name)])
    assert backend.platform() == expect
    assert backend.interpret() is (expect == "cpu")


@pytest.mark.parametrize("name", ["tpu", "rocm", "metal"])
def test_platform_raises_on_any_other(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "devices", lambda: [SimpleNamespace(platform=name)])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()


def test_compile_cache_dir_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    path = backend.compile_cache_dir()
    assert path == os.path.join(backend.REPO_DIR, ".jax_cache")
    assert path == backend.compile_cache_dir()  # no pid/time component


def test_compile_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_compile_cache_sets_config_only_without_env(monkeypatch, tmp_path, env_set):
    seen = []
    monkeypatch.setattr(backend.jax.config, "update", lambda k, v: seen.append((k, v)))
    if env_set:
        monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
        assert backend.enable_compile_cache() == str(tmp_path)
        assert seen == []  # JAX reads the variable itself
    else:
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
        path = backend.enable_compile_cache()
        assert seen == [("jax_compilation_cache_dir", path)]


# ------------------------------------------------------ dispatch on the GPU --


@pytest.fixture()
def on_gpu(monkeypatch):
    """Pretend the platform is the GPU (the kernels still run in interpret
    mode, since the devices are the CPU's) and count kernel calls."""
    import svd_lstm_tpu.api as api

    monkeypatch.setattr(api, "platform", lambda: "gpu")
    calls = []
    orig = gr.stack_forward

    def spy(params, x, precision="highest"):
        calls.append(precision)
        return orig(params, x, precision=precision)

    monkeypatch.setattr(gr, "stack_forward", spy)
    return calls


def _family(name, units):
    import svd_lstm_tpu as st

    dense = init_stacked_lstm(jax.random.PRNGKey(4), 4, units)
    if name == "dense":
        return dense
    smodel = st.make_singular_model(dense, merged_kernel=False)
    return smodel if name == "singular" else st.make_reduced_model(smodel, rank=4)


@pytest.mark.parametrize("precision,kernel_precision", [("exact", "highest"), ("fast", "default")])
@pytest.mark.parametrize("family", ["dense", "singular", "reduced"])
def test_predict_batch1_narrow_takes_kernel_on_gpu(on_gpu, family, precision, kernel_precision):
    from svd_lstm_tpu.api import predict

    model = _family(family, (8, 8))
    x = jnp.asarray(np.random.default_rng(5).normal(size=(9, 4)), jnp.float32)
    y = predict(model, x, precision=precision, consult_cache=False)
    assert on_gpu == [kernel_precision]
    y_scan = predict(model, x, impl="scan", consult_cache=False)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_scan), atol=2e-5)


@pytest.mark.parametrize(
    "units,precision,shape",
    [((100,), "exact", (9, 4)),       # past the exact kernel's 64 units
     ((200,), "fast", (9, 4)),        # past the TF32 kernel's 128
     ((8,), "exact", (2, 9, 4)),      # batched input
     ((8,), "fast", (2, 9, 4))],
)
def test_predict_takes_scan_on_gpu(on_gpu, units, precision, shape):
    from svd_lstm_tpu.api import predict

    model = init_stacked_lstm(jax.random.PRNGKey(6), 4, units)
    x = jnp.zeros(shape, jnp.float32)
    predict(model, x, precision=precision, consult_cache=False)
    assert on_gpu == []


def test_predict_batch1_takes_scan_off_gpu():
    """On the CPU impl='auto' never takes the kernel (it would run
    interpreted); impl='fused' asks for it explicitly."""
    from svd_lstm_tpu.api import predict

    calls = []
    model = init_stacked_lstm(jax.random.PRNGKey(7), 4, (8,))
    x = jnp.zeros((5, 4), jnp.float32)
    orig = gr.stack_forward
    gr.stack_forward = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        predict(model, x, consult_cache=False)
        assert calls == []
        predict(model, x, impl="fused", consult_cache=False)
        assert calls == [1]
    finally:
        gr.stack_forward = orig


@pytest.mark.parametrize(
    "family", ["dense", "singular", "reduced", "conv_dense", "conv_singular", "conv_reduced"]
)
def test_resolve_train_apply_fn_swaps_every_family(family):
    from svd_lstm_tpu.config import TrainConfig
    from svd_lstm_tpu.models import conv, reduced, singular
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply
    from svd_lstm_tpu.ops import conv_train, reduced_train, singular_train
    from svd_lstm_tpu.train.loop import resolve_train_apply_fn

    scan, kernel = {
        "dense": (stacked_lstm_apply, gr.stacked_lstm_apply_fast_train),
        "singular": (singular.singular_lstm_apply, singular_train.singular_lstm_apply_fast_train),
        "reduced": (reduced.reduced_lstm_apply, reduced_train.reduced_lstm_apply_fast_train),
        "conv_dense": (conv.conv_lstm_apply, conv_train.conv_lstm_apply_fast_train),
        "conv_singular": (conv.conv_singular_apply, conv_train.conv_singular_apply_fast_train),
        "conv_reduced": (conv.conv_reduced_apply, conv_train.conv_reduced_apply_fast_train),
    }[family]
    assert resolve_train_apply_fn(TrainConfig(recurrence_kernel=True), scan) == (kernel, True)
    assert resolve_train_apply_fn(TrainConfig(), scan) == (scan, False)


def test_wide_stack_trains_on_scan_with_one_log_line(caplog):
    """A layer wider than the kernel takes sends the whole stack to the
    lax.scan, and says so once."""
    import logging

    from svd_lstm_tpu.models.lstm import stacked_lstm_apply

    params = init_stacked_lstm(jax.random.PRNGKey(8), 4, (8, 130))
    x = jnp.asarray(np.random.default_rng(9).normal(size=(2, 3, 4)), jnp.float32)
    with caplog.at_level(logging.WARNING, logger=gr.__name__):
        y = gr.stacked_lstm_apply_fast_train(params, x)
    assert len([r for r in caplog.records if "lax.scan" in r.getMessage()]) == 1
    np.testing.assert_allclose(np.asarray(y), np.asarray(stacked_lstm_apply(params, x)),
                               atol=1e-6)


# ------------------------------------------------------------ chip_smoke --


def _run_chip_smoke(cwd, with_repo=True):
    from conftest import subprocess_env

    env = subprocess_env(JAX_PLATFORMS="cpu")
    if not with_repo:
        env.pop("PYTHONPATH")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_exits_nonzero_on_cpu():
    from conftest import REPO_DIR

    out = _run_chip_smoke(REPO_DIR)
    assert out.returncode != 0
    assert out.stdout.strip() == ""  # no result line, no phase output
    assert "needs the GPU" in out.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    it fails (it drives the program; it is not the program)."""
    import shutil

    from conftest import REPO_DIR

    shutil.copy(os.path.join(REPO_DIR, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(str(tmp_path), with_repo=False)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
