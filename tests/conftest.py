"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices so multi-device sharding code
is exercised without the hardware, and the Pallas kernels run in interpret
mode (``utils.backend.interpret``). Env must be set before jax initializes
its backends.

Exception — the on-GPU tests (``@pytest.mark.gpu``, tests/test_gpu_compiled.py)
run the compiled Triton kernels. ``chip_smoke.py`` runs them in its own
process, on the card, through ``pytest.main``; it sets
``SVD_LSTM_TESTS_ON_DEVICE=1`` so that this module leaves the backend alone.
Collection is identical either way: whether a card is present is decided
inside the ``gpu`` fixture, never at import.
"""

import os

ON_DEVICE = os.environ.get("SVD_LSTM_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import numpy as np
import pytest

if not ON_DEVICE:
    # backend initialization is lazy: the config pin wins even if jax was
    # imported before the environment variable was set
    jax.config.update("jax_platforms", "cpu")

REFERENCE_DIR = os.environ.get("REFERENCE_DIR", "/root/reference")
REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env(**overrides) -> dict:
    """Environment for subprocess tests: the repo prepended to PYTHONPATH
    with every existing entry preserved, plus ``overrides``. An override
    of ``None`` removes the variable."""
    env = dict(os.environ)
    for k, v in overrides.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p and p != REPO_DIR]
    env["PYTHONPATH"] = os.pathsep.join([REPO_DIR] + pp)
    return env


@pytest.fixture()
def gpu():
    """The GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs the GPU (JAX found {dev.platform}); run python chip_smoke.py")
    return dev


@pytest.fixture(scope="session")
def reference_dir():
    """Path to the upstream reference checkout; tests that golden-check
    against its shipped CSV fixtures skip when it is absent."""
    if not os.path.isdir(os.path.join(REFERENCE_DIR, "code")):
        pytest.skip("reference checkout not available")
    return REFERENCE_DIR


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
