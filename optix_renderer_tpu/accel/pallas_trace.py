"""Brute-force ray-triangle kernels through Pallas' Triton route.

The brute-force tier on the GPU (``accel.traverse`` dispatches here when
the program is lowered for CUDA).  One program owns a power-of-two block
of rays; an in-kernel loop walks the packed ``(Tpad, 16)`` triangle table,
reading each triangle's row as scalars (uniform across the block, so they
broadcast), and keeps the closest hit (or the occlusion bit) in
registers: no per-triangle round trip of the running hit through device
memory, which is what the jnp tier's chunk loop pays.  The plain
reference is the jnp brute tier in ``accel.traverse``;
``tests/unit/test_pallas_trace.py`` checks the kernels against the oracle
in interpret mode.

The packed triangle row is ``[v0(3), e1(3), e2(3), prim_id(1), pad(6)]``
with ``prim_id`` stored as f32 (exact for ids < 2^24), so the kernels
return hits in ORIGINAL triangle order directly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.types import Hit, Ray

_INF = np.float32(3.0e38)
BLOCK_RAYS = 128  # rays per program (a power of two, as Triton requires)
_NUM_WARPS = 4
_RAY_CH = 8  # packed ray rows: o(3) d(3) t_max(1) t_min(1)


def _mt(c, ox, oy, oz, dx, dy, dz, t_lo, t_cur):
    """No-cull Moller-Trumbore of one triangle (column accessor ``c``)
    against the ray block; hits with t_lo < t < t_cur."""
    v0x, v0y, v0z = c(0), c(1), c(2)
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = ((jnp.abs(det) >= 1e-12) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_lo) & (t < t_cur))
    return hit, t, u, v


def _rays(ray_ref):
    return [ray_ref[j, :] for j in range(_RAY_CH)]


def _closest_kernel(n_tris, tri_ref, ray_ref, t_ref, id_ref, u_ref, v_ref):
    ox, oy, oz, dx, dy, dz, tmax, tmin = _rays(ray_ref)

    def body(k, carry):
        t, pid, uu, vv = carry
        c = lambda j: tri_ref[k, j]
        hit, tk, uk, vk = _mt(c, ox, oy, oz, dx, dy, dz, tmin, t)
        return (jnp.where(hit, tk, t), jnp.where(hit, c(9), pid),
                jnp.where(hit, uk, uu), jnp.where(hit, vk, vv))

    z = jnp.zeros_like(tmax)
    t, pid, uu, vv = jax.lax.fori_loop(0, n_tris, body, (tmax, z - 1.0, z, z))
    t_ref[...] = t
    id_ref[...] = pid.astype(jnp.int32)
    u_ref[...] = uu
    v_ref[...] = vv


def _any_kernel(n_tris, tri_ref, ray_ref, occ_ref):
    ox, oy, oz, dx, dy, dz, tmax, tmin = _rays(ray_ref)

    def body(k, occ):
        hit, _, _, _ = _mt(lambda j: tri_ref[k, j], ox, oy, oz, dx, dy, dz,
                           tmin, tmax)
        return occ | hit.astype(jnp.int32)

    occ_ref[...] = jax.lax.fori_loop(0, n_tris, body, jnp.zeros(ox.shape, jnp.int32))


def pack_tri_table(tri_v0, tri_e1, tri_e2, prim_id) -> jnp.ndarray:
    """(Tpad, 16) f32 table, Tpad the next power of two; pad rows are
    degenerate (e1 = e2 = 0 -> det = 0, never hit) with prim id -1."""
    T = tri_v0.shape[0]
    rows = jnp.concatenate(
        [jnp.asarray(tri_v0, jnp.float32), jnp.asarray(tri_e1, jnp.float32),
         jnp.asarray(tri_e2, jnp.float32),
         jnp.asarray(prim_id, jnp.float32)[:, None],
         jnp.zeros((T, 6), jnp.float32)], axis=1)
    pad = pl.next_power_of_2(T) - T
    return jnp.concatenate(
        [rows, jnp.zeros((pad, 16), jnp.float32).at[:, 9].set(-1.0)], axis=0)


def _pack_rays(rays: Ray, t_min, t_max, n_pad: int) -> jnp.ndarray:
    n = rays.origin.shape[0]
    per_ray = lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float32), (n,))[:, None]
    packed = jnp.concatenate(
        [rays.origin, rays.direction, per_ray(t_max), per_ray(t_min)], axis=1)
    return jnp.pad(packed, ((0, n_pad - n), (0, 0))).T  # (8, n_pad)


def _call(kernel, n_tris, tri_tab, rays, t_min, t_max, out_dtypes, interpret,
          name):
    n = rays.origin.shape[0]
    n_pad = pl.cdiv(n, BLOCK_RAYS) * BLOCK_RAYS
    rspec = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    outs = pl.pallas_call(
        functools.partial(kernel, n_tris),
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[pl.BlockSpec(tri_tab.shape, lambda i: (0, 0)),
                  pl.BlockSpec((_RAY_CH, BLOCK_RAYS), lambda i: (0, i))],
        out_specs=[rspec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), d) for d in out_dtypes],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name=name,
    )(tri_tab, _pack_rays(rays, t_min, t_max, n_pad))
    return [o[:n] for o in outs]


@functools.partial(jax.jit, static_argnames=("n_tris", "interpret"))
def trace_closest_tiles(tri_tab: jnp.ndarray, rays: Ray, t_max=_INF,
                        t_min=0.0, *, n_tris: int | None = None,
                        interpret: bool = False) -> Hit:
    """Brute-force closest hit over the packed table; Hit in original ids.
    ``t_min``/``t_max`` may be per-ray; ``n_tris`` (default: every table
    row) bounds the triangle loop."""
    n_tris = tri_tab.shape[0] if n_tris is None else n_tris
    f32 = jnp.float32
    t, tri, u, v = _call(_closest_kernel, n_tris, tri_tab, rays, t_min, t_max,
                         (f32, jnp.int32, f32, f32), interpret, "trace_closest")
    return Hit(t=t, tri_id=tri, bary_u=u, bary_v=v)


@functools.partial(jax.jit, static_argnames=("n_tris", "interpret"))
def trace_any_tiles(tri_tab: jnp.ndarray, rays: Ray, t_max=_INF, t_min=0.0,
                    *, n_tris: int | None = None,
                    interpret: bool = False) -> jnp.ndarray:
    """Brute-force any-hit (occlusion) over the packed table."""
    n_tris = tri_tab.shape[0] if n_tris is None else n_tris
    (occ,) = _call(_any_kernel, n_tris, tri_tab, rays, t_min, t_max,
                   (jnp.int32,), interpret, "trace_any")
    return occ != 0


def _bvh_table(bvh):
    return pack_tri_table(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.prim_id)


def trace_closest_kernel(bvh, rays: Ray, t_min=0.0, t_max=_INF) -> Hit:
    """:func:`trace_closest_tiles` over a BVH's triangle soup (the GPU
    brute tier; same signature as ``traverse.trace_closest_brute_jnp``)."""
    return trace_closest_tiles(_bvh_table(bvh), rays, t_max, t_min,
                               n_tris=bvh.tri_v0.shape[0])


def trace_any_kernel(bvh, rays: Ray, t_min=0.0, t_max=_INF) -> jnp.ndarray:
    """:func:`trace_any_tiles` over a BVH's triangle soup."""
    return trace_any_tiles(_bvh_table(bvh), rays, t_max, t_min,
                           n_tris=bvh.tri_v0.shape[0])
