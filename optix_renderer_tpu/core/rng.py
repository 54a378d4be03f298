"""Bit-exact batched LCG RNG.

Reimplements the reference's per-pixel RNG (``cuda_include/lcg_random.cuh``)
as vectorized uint32 arithmetic: a 32-bit LCG (a=1664525, c=1013904223)
seeded by MurmurHash3 of the linear pixel index mixed with the frame id.
Keeping the generator bit-identical lets estimator outputs be compared
sample-for-sample against a CPU oracle, and keeps variance behaviour
identical to the reference at equal spp.

The state lives as one ``uint32`` lane per ray; the whole generator is a
handful of integer ops, fully fused by XLA into the consuming kernel.
``jax.random`` is deliberately NOT used here (different stream semantics,
not bit-comparable); it remains available elsewhere for non-replay use.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy (host) constants: module-level jnp arrays become hoisted
# executable inputs in this jax build and break steady-state dispatch;
# np scalars are baked into the HLO as literals.
_LCG_A = np.uint32(1664525)  # lcg_random.cuh:43
_LCG_C = np.uint32(1013904223)  # lcg_random.cuh:44


def murmur_hash3_mix(hash_: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """MurmurHash3 mix round (lcg_random.cuh:11-28), uint32 batched."""
    c1 = np.uint32(0xCC9E2D51)
    c2 = np.uint32(0x1B873593)
    k = (k * c1).astype(jnp.uint32)
    k = (k << 15) | (k >> 17)
    k = (k * c2).astype(jnp.uint32)
    hash_ = hash_ ^ k
    hash_ = (hash_ << 13) | (hash_ >> 19)
    return (hash_ * np.uint32(5) + np.uint32(0xE6546B64)).astype(jnp.uint32)


def murmur_hash3_finalize(hash_: jnp.ndarray) -> jnp.ndarray:
    """MurmurHash3 finalizer (lcg_random.cuh:30-39)."""
    hash_ = hash_ ^ (hash_ >> 16)
    hash_ = (hash_ * np.uint32(0x85EBCA6B)).astype(jnp.uint32)
    hash_ = hash_ ^ (hash_ >> 13)
    hash_ = (hash_ * np.uint32(0xC2B2AE35)).astype(jnp.uint32)
    return hash_ ^ (hash_ >> 16)


def make_rng(frame_id, linear_pixel_idx: jnp.ndarray) -> jnp.ndarray:
    """Seed per-ray states; equivalent of ``get_rng`` (lcg_random.cuh:54-62).

    frame_id: scalar int (traced ok); linear_pixel_idx: uint32/int array of
    ``pixel.x + pixel.y * dims.x``.  Returns uint32 state array.
    """
    idx = linear_pixel_idx.astype(jnp.uint32)
    fid = jnp.asarray(frame_id).astype(jnp.uint32)
    state = murmur_hash3_mix(jnp.zeros_like(idx), idx)
    state = murmur_hash3_mix(state, jnp.broadcast_to(fid, state.shape).astype(jnp.uint32))
    return murmur_hash3_finalize(state)


def lcg_step(state: jnp.ndarray) -> jnp.ndarray:
    """Advance the LCG (lcg_random.cuh:41-47); returns the new state (also the sample)."""
    return (state * _LCG_A + _LCG_C).astype(jnp.uint32)


def lcg_randomf(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Draw float32 uniforms in [0,1); returns (new_state, floats).

    Matches ``lcg_randomf`` (lcg_random.cuh:49-52): ldexp((float)u32, -32)
    — the uint32 is rounded to float32 (round-to-nearest-even above 2^24,
    exactly as CUDA's (float) cast) then scaled by 2^-32.
    """
    new_state = lcg_step(state)
    return new_state, new_state.astype(jnp.float32) * jnp.float32(2.0**-32)


def lcg_randomf2(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Draw two uniforms (common vec2f rand pattern); returns (state, u1, u2)."""
    state, u1 = lcg_randomf(state)
    state, u2 = lcg_randomf(state)
    return state, u1, u2
