"""The one place that decides which device the program runs on.

Every kernel choice and solver rule asks `platform()` instead of
`jax.default_backend()`.  Only "gpu" (NVIDIA, CUDA) and "cpu" are
supported; anything else raises rather than silently picking a path.
`require_gpu()` is the guard for entry points that must not fall back
to the CPU, and `enable_compile_cache()` places JAX's persistent
compilation cache.
"""

from __future__ import annotations

import os
import pathlib

import jax

PLATFORMS = ("gpu", "cpu")

# Fixed default cache location inside the checkout: the cache key
# includes the path, so a directory that moves never hits.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def platform() -> str:
    """"gpu" or "cpu" for the default JAX backend; raises otherwise."""
    p = jax.default_backend()
    if p == "cuda":
        p = "gpu"
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {p!r}; this program runs on an "
            f"NVIDIA GPU or on the CPU"
        )
    return p


def require_gpu() -> list:
    """The GPU devices, or a RuntimeError when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise RuntimeError(f"no GPU visible to JAX: {e}") from None
    if not devs:
        raise RuntimeError("no GPU visible to JAX")
    return devs


def compile_cache_dir() -> pathlib.Path:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else DEFAULT_CACHE_DIR


def enable_compile_cache() -> pathlib.Path:
    """Turn on the persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set JAX already reads it, and
    no other directory is set here."""
    d = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
