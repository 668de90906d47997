"""The one backend predicate, and the compile-cache location.

Every choice that depends on the device goes through :func:`platform`:
the Pallas kernels run compiled on ``"gpu"`` and in interpret mode on
``"cpu"``; any other platform is an error, not a fallback.
"""

from __future__ import annotations

import os

import jax

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the platform of the default device. Raises
    on anything else (the system has no code path for it)."""
    p = jax.devices()[0].platform
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: svd_lstm_tpu runs on 'gpu' "
            "(CUDA) or, for tests, on 'cpu' with kernels in interpret mode"
        )
    return p


def interpret() -> bool:
    """Whether Pallas kernels run in interpret mode: exactly when the
    platform is the CPU."""
    return platform() == "cpu"


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else the fixed ``<repo>/.jax_cache`` (a fixed path, since the
    path is part of the cache key)."""
    return os.environ.get(CACHE_ENV) or os.path.join(REPO_DIR, ".jax_cache")


def enable_compile_cache() -> str:
    """Entry-point set-up: point JAX at :func:`compile_cache_dir` unless the
    environment already did (JAX reads the variable itself). Returns the
    directory in use."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
