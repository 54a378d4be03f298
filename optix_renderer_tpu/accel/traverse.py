"""Vectorized BVH traversal (the stand-in for the reference's RT cores).

Two tiers, chosen from the scene size alone (a trace-time constant), so
the same code runs on every backend:

* up to ``BRUTE_MAX_TRIS`` triangles, brute force, every ray against every
  triangle: a Pallas kernel (``accel.pallas_trace``) when the program is
  lowered for CUDA, a chunked jnp loop (the reference) elsewhere;
* above that, the skip-link BVH walk: one ``lax.while_loop`` advances ALL
  rays in lock-step; each lane holds a single node pointer into the
  skip-link BVH (``accel.build``), so an iteration is (gather node AABB)
  -> (slab test) -> (masked leaf triangle tests) -> (select next pointer).
  No stack and no data-dependent shapes.

Entry points: :func:`trace_closest` (fills a :class:`core.types.Hit`) and
:func:`trace_any` (visibility with early termination).  A lane whose
``t_max`` is <= 0 is inactive: it returns a miss and costs the walk
nothing.  The O(R*T) oracle :func:`intersect_brute` validates both tiers.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..core.types import Hit, Ray
from .build import BVH
from .pallas_trace import trace_any_kernel, trace_closest_kernel

LEAF_SIZE = 4  # must match accel.build leaf_size default
_INF = np.float32(3.0e38)  # np, not jnp: device module constants get hoisted as executable inputs


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Batched no-cull Möller-Trumbore; returns (hit, t, u, v).

    No backface culling, matching OptiX defaults in the reference (no
    OPTIX_RAY_FLAG_CULL_* anywhere in the device code).
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) >= 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def _slab_test(o, inv_d, bmin, bmax, t_min, t_max):
    """Ray-AABB slab test; inv_d precomputed (inf components are fine)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(near, axis=-1), t_min)
    t_far = jnp.minimum(jnp.min(far, axis=-1), t_max)
    return t_near <= t_far


# Scenes up to this size take the brute tier; above it, the walk.  The
# crossover has not been measured on the GPU yet.
BRUTE_MAX_TRIS = 4096
_BRUTE_CHUNK = 32


def trace_closest(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> Hit:
    """Closest hit over a ray batch, brute force or skip-link walk by
    scene size.  ``t_max`` may be per-ray (R,).  Returns Hit in ORIGINAL
    triangle ids."""
    if bvh.tri_v0.shape[0] <= BRUTE_MAX_TRIS:
        return trace_closest_brute(bvh, rays, t_min, t_max)
    return trace_closest_bvh(bvh, rays, t_min, t_max)


def trace_any(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> jnp.ndarray:
    """Visibility query: True where any hit lies in (t_min, t_max); tier
    chosen as in :func:`trace_closest`."""
    if bvh.tri_v0.shape[0] <= BRUTE_MAX_TRIS:
        return trace_any_brute(bvh, rays, t_min, t_max)
    return trace_any_bvh(bvh, rays, t_min, t_max)


def trace_closest_brute(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> Hit:
    """Brute-force closest hit: the Triton kernel on the GPU, the jnp
    tier elsewhere (a lowering-time platform choice)."""
    return jax.lax.platform_dependent(
        bvh, rays, t_min, t_max,
        cuda=trace_closest_kernel, default=trace_closest_brute_jnp)


def trace_any_brute(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> jnp.ndarray:
    """Brute-force any-hit, dispatched like :func:`trace_closest_brute`."""
    return jax.lax.platform_dependent(
        bvh, rays, t_min, t_max,
        cuda=trace_any_kernel, default=trace_any_brute_jnp)


def trace_any_brute_jnp(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> jnp.ndarray:
    """Brute-force any-hit: True where an occluder exists in (t_min, t_max).

    Same chunked layout as trace_closest_brute_jnp but only ORs hit flags — no
    closest-t/tri/bary selects per triangle. t_max may be per-ray (R,)."""
    o = rays.origin
    d = rays.direction
    R = o.shape[0]
    T = bvh.tri_v0.shape[0]
    Tp = _pad_count(T)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    pad = Tp - T
    v0 = jnp.pad(bvh.tri_v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(bvh.tri_e1, ((0, pad), (0, 0)))
    e2 = jnp.pad(bvh.tri_e2, ((0, pad), (0, 0)))

    def chunk_body(c, occ):
        base = c * _BRUTE_CHUNK
        v0c = jax.lax.dynamic_slice(v0, (base, 0), (_BRUTE_CHUNK, 3))
        e1c = jax.lax.dynamic_slice(e1, (base, 0), (_BRUTE_CHUNK, 3))
        e2c = jax.lax.dynamic_slice(e2, (base, 0), (_BRUTE_CHUNK, 3))
        for i in range(_BRUTE_CHUNK):
            h, _, _, _ = _moller_trumbore(o, d, v0c[i], e1c[i], e2c[i], t_min, t_max)
            occ = occ | h
        return occ

    occ0 = jnp.zeros((R,), jnp.bool_)
    n_chunks = Tp // _BRUTE_CHUNK
    if n_chunks == 1:
        return chunk_body(0, occ0)
    return jax.lax.fori_loop(0, n_chunks, chunk_body, occ0)


def _pad_count(t: int) -> int:
    return -(-t // _BRUTE_CHUNK) * _BRUTE_CHUNK


def trace_closest_brute_jnp(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> Hit:
    """Brute-force closest hit: fori over triangle chunks with a
    statically-unrolled inner loop.

    Chunk loads are contiguous ``dynamic_slice``s and the per-triangle data
    are scalars broadcast across the whole ray batch: no dynamic gathers.
    This is the CPU path and the reference for the GPU kernel, which runs
    several times faster on the card (PERF.md, kernel decisions).
    """
    o = rays.origin
    d = rays.direction
    R = o.shape[0]
    T = bvh.tri_v0.shape[0]
    Tp = _pad_count(T)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    pad = Tp - T
    v0 = jnp.pad(bvh.tri_v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(bvh.tri_e1, ((0, pad), (0, 0)))  # degenerate pad tris never hit
    e2 = jnp.pad(bvh.tri_e2, ((0, pad), (0, 0)))
    prim = jnp.pad(bvh.prim_id, (0, pad))

    def chunk_body(c, state):
        t, tri, bu, bv = state
        base = c * _BRUTE_CHUNK
        v0c = jax.lax.dynamic_slice(v0, (base, 0), (_BRUTE_CHUNK, 3))
        e1c = jax.lax.dynamic_slice(e1, (base, 0), (_BRUTE_CHUNK, 3))
        e2c = jax.lax.dynamic_slice(e2, (base, 0), (_BRUTE_CHUNK, 3))
        pc = jax.lax.dynamic_slice(prim, (base,), (_BRUTE_CHUNK,))
        for i in range(_BRUTE_CHUNK):
            h, tk, uk, vk = _moller_trumbore(o, d, v0c[i], e1c[i], e2c[i], t_min, t)
            t = jnp.where(h, tk, t)
            tri = jnp.where(h, pc[i], tri)
            bu = jnp.where(h, uk, bu)
            bv = jnp.where(h, vk, bv)
        return t, tri, bu, bv

    t0 = t_max.astype(jnp.float32)
    tri0 = jnp.full((R,), -1, jnp.int32)
    z = jnp.zeros((R,), jnp.float32)
    n_chunks = Tp // _BRUTE_CHUNK
    if n_chunks == 1:
        t, tri, bu, bv = chunk_body(0, (t0, tri0, z, z))
    else:
        t, tri, bu, bv = jax.lax.fori_loop(0, n_chunks, chunk_body, (t0, tri0, z, z))
    return Hit(t=t, tri_id=tri, bary_u=bu, bary_v=bv)


def trace_closest_bvh(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> Hit:
    """Closest-hit skip-link BVH walk. Returns Hit in ORIGINAL tri ids.
    ``t_max`` may be per-ray (R,); lanes with t_max <= 0 do no work."""
    o = rays.origin
    d = rays.direction
    n_nodes = bvh.num_nodes
    R = o.shape[0]

    safe_d = jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    inv_d = 1.0 / safe_d

    def cond(state):
        node, _, _, _, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t, tri, bu, bv = state
        active = node < n_nodes
        idx = jnp.where(active, node, 0)

        bmin = bvh.node_min[idx]
        bmax = bvh.node_max[idx]
        hit_aabb = active & _slab_test(o, inv_d, bmin, bmax, t_min, t)

        count = bvh.node_tri_count[idx]
        offset = bvh.node_tri_offset[idx]
        is_leaf = count > 0

        test_leaf = hit_aabb & is_leaf
        for k in range(LEAF_SIZE):
            valid = test_leaf & (k < count)
            tid = jnp.where(valid, offset + k, 0)
            h, tk, uk, vk = _moller_trumbore(
                o, d, bvh.tri_v0[tid], bvh.tri_e1[tid], bvh.tri_e2[tid], t_min, t
            )
            closer = valid & h
            t = jnp.where(closer, tk, t)
            tri = jnp.where(closer, bvh.prim_id[tid], tri)
            bu = jnp.where(closer, uk, bu)
            bv = jnp.where(closer, vk, bv)

        descend = hit_aabb & ~is_leaf
        nxt = jnp.where(descend, idx + 1, bvh.node_skip[idx])
        node = jnp.where(active, nxt, node)
        return node, t, tri, bu, bv

    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    node0 = jnp.where(t0 > 0.0, 0, n_nodes).astype(jnp.int32)
    tri0 = jnp.full((R,), -1, jnp.int32)
    z = jnp.zeros((R,), jnp.float32)
    node, t, tri, bu, bv = jax.lax.while_loop(cond, body, (node0, t0, tri0, z, z))
    return Hit(t=t, tri_id=tri, bary_u=bu, bary_v=bv)


def trace_any_bvh(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> jnp.ndarray:
    """Visibility query: True where ANY hit exists in (t_min, t_max).

    Early-out: a lane that finds an occluder jumps straight to the
    sentinel. t_max may be per-ray (R,) — used for shadow rays toward a
    sampled light point; lanes with t_max <= 0 do no work.
    """
    o = rays.origin
    d = rays.direction
    n_nodes = bvh.num_nodes
    R = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    safe_d = jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    inv_d = 1.0 / safe_d

    def cond(state):
        node, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, occluded = state
        active = node < n_nodes
        idx = jnp.where(active, node, 0)

        hit_aabb = active & _slab_test(o, inv_d, bvh.node_min[idx], bvh.node_max[idx], t_min, t_max)
        count = bvh.node_tri_count[idx]
        offset = bvh.node_tri_offset[idx]
        is_leaf = count > 0

        found = jnp.zeros_like(occluded)
        test_leaf = hit_aabb & is_leaf
        for k in range(LEAF_SIZE):
            valid = test_leaf & (k < count)
            tid = jnp.where(valid, offset + k, 0)
            h, _, _, _ = _moller_trumbore(
                o, d, bvh.tri_v0[tid], bvh.tri_e1[tid], bvh.tri_e2[tid], t_min, t_max
            )
            found = found | (valid & h)

        occluded = occluded | found
        descend = hit_aabb & ~is_leaf & ~occluded
        nxt = jnp.where(descend, idx + 1, bvh.node_skip[idx])
        nxt = jnp.where(found, n_nodes, nxt)  # early out
        node = jnp.where(active, nxt, node)
        return node, occluded

    node0 = jnp.where(t_max > 0.0, 0, n_nodes).astype(jnp.int32)
    occ0 = jnp.zeros((R,), jnp.bool_)
    _, occluded = jax.lax.while_loop(cond, body, (node0, occ0))
    return occluded


def intersect_brute(tri_verts: jnp.ndarray, rays: Ray, t_min: float = 0.0, t_max: float = _INF) -> Hit:
    """O(R*T) oracle: scan over all triangles with lax.fori_loop.

    tri_verts: (T, 3, 3). Ground truth for traversal tests (SURVEY.md §7.2
    step 3) and tiny scenes.
    """
    o = rays.origin
    d = rays.direction
    R = o.shape[0]
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    T = tri_verts.shape[0]

    def body(i, state):
        t, tri, bu, bv = state
        h, tk, uk, vk = _moller_trumbore(o, d, v0[i], e1[i], e2[i], t_min, t)
        closer = h
        t = jnp.where(closer, tk, t)
        tri = jnp.where(closer, i, tri)
        bu = jnp.where(closer, uk, bu)
        bv = jnp.where(closer, vk, bv)
        return t, tri, bu, bv

    t0 = jnp.full((R,), t_max, jnp.float32)
    tri0 = jnp.full((R,), -1, jnp.int32)
    z = jnp.zeros((R,), jnp.float32)
    t, tri, bu, bv = jax.lax.fori_loop(0, T, body, (t0, tri0, z, z))
    return Hit(t=t, tri_id=tri, bary_u=bu, bary_v=bv)
