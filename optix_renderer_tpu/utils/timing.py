"""Timing convention shared by the benchmarks.

JAX dispatch is asynchronous, so every timed region ends in
``jax.block_until_ready`` on the result.
"""

from __future__ import annotations

import time

import jax


def timeit(f, *args, iters: int = 8, warmup: int = 2):
    """Time ``f(*args)``.

    Returns ``(res, out)`` where ``res = {"cold_s", "amortized_s"}`` and
    ``out`` is the last result.  ``amortized_s`` chains ``iters``
    dispatches and waits once (what a frame loop pays per frame);
    ``cold_s`` is one dispatch and one wait.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = f(*args)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    amortized = (time.perf_counter() - t0) / iters
    return {"cold_s": cold, "amortized_s": amortized}, out
