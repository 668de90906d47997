"""Driver entry points: entry() compiles; dryrun_multichip executes."""

import sys
import os

import numpy as np
import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8, 1)
    assert np.isfinite(np.asarray(out)).all()


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_odd():
    graft.dryrun_multichip(3)  # tp falls back to 1


def test_dryrun_multichip_driver_environment():
    """``dryrun_multichip`` may run in a process WITHOUT conftest's CPU
    pinning. It must pin the platform and the virtual device count itself
    so that ``jnp.asarray`` / optimizer init / ``device_put`` cannot
    dispatch to an accelerator. Run it in a subprocess with no
    JAX_PLATFORMS / XLA_FLAGS pins.
    """
    import subprocess

    from conftest import REPO_DIR as repo
    from conftest import subprocess_env

    env = subprocess_env(JAX_PLATFORMS=None, XLA_FLAGS=None)
    res = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
        cwd=repo,
    )
    assert res.returncode == 0, f"stderr tail:\n{res.stderr[-3000:]}"
    assert "dryrun_multichip OK" in res.stdout
    # every stage of the sharded compression chain parity-checked, plus
    # tp=4 and the odd-device-count fallback
    for line in (
        "check dense_dp4xtp2_parity: OK",
        "check dense_dp2xtp4_parity: OK",
        "check dense_dp3xtp1_odd_fallback_parity: OK",
        "check singular_finetune_dp_parity: OK",
        "check reduced_batched_dp_parity: OK",
        "check batched_fast_dp_parity: OK",
        "check pipeline_pp_parity: OK",
    ):
        assert line in res.stdout, f"missing sub-check: {line}"
