"""Bilinear texture sampling from the flat atlas.

Without hardware texture units this reproduces CUDA ``tex2D<float4>`` with
LINEAR filtering and CLAMP addressing (the mode the reference uses for
both mesh textures, hit_miss.cuh:42, and the LTC LUTs, viewer.hpp:322-327)
as four gathers + lerp.  Texel centers sit at (i + 0.5) / size.
"""

from __future__ import annotations

import jax.numpy as jnp

from .device import TextureAtlas


def sample_bilinear(atlas: TextureAtlas, tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Sample atlas texture ``tex_id`` at (u, v) in [0,1]^2, bilinear+clamp.

    tex_id: (N,) int32 (values < 0 are sampled from texture 0 — callers
    mask the result). u, v: (N,). Returns (N, 4) float32 RGBA.
    """
    tid = jnp.maximum(tex_id, 0)
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]

    x = u * w.astype(jnp.float32) - 0.5
    y = v * h.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f

    x0 = jnp.clip(x0f.astype(jnp.int32), 0, w - 1)
    x1 = jnp.clip(x0f.astype(jnp.int32) + 1, 0, w - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, h - 1)

    def texel(yi, xi):
        return atlas.pixels[off + yi * w + xi]

    t00 = texel(y0, x0)
    t01 = texel(y0, x1)
    t10 = texel(y1, x0)
    t11 = texel(y1, x1)
    fx = fx[..., None]
    fy = fy[..., None]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
