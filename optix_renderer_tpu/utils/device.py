"""Process set-up shared by every entry point: the persistent compile
cache and the accelerator check of the measurement scripts."""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache: a fixed path, so every process of a checkout
# shares one cache (the path is part of each entry's key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at
    :data:`DEFAULT_CACHE_DIR`.  Call before the first compile: JAX reads
    the setting once, when it first compiles.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpus(count: int = 1, devices=None) -> list:
    """The first ``count`` devices, which must be GPUs; raises otherwise.

    Measurement scripts call this so that a run without an accelerator
    fails instead of timing the CPU."""
    devices = list(jax.devices() if devices is None else devices)
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < count:
        found = ", ".join(sorted({d.platform for d in devices})) or "none"
        raise RuntimeError(
            f"need {count} GPU device(s), found {len(gpus)} (platforms: {found})")
    return gpus[:count]
