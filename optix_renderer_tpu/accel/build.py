"""Host LBVH construction (numpy).

Builds a binary BVH over triangles by sorting Morton codes of centroid
positions and median-splitting the sorted range, then flattens it in DFS
order with *skip links*: traversal needs no per-ray stack, just one node
pointer per lane, so the inner loop is vectorized gathers + selects with
no divergence-managed state (SURVEY.md §7.3 hard-part #1).

The builder is fully iterative (explicit DFS stack + memoized subtree
sizes; no Python recursion) and AABBs are computed vectorized per level of
the leaf loop + a single reverse merge pass, so a ~1M-triangle build stays
in the seconds range.

Layout invariants (consumed by ``accel.traverse``):
* node 0 is the root; an inner node's first child is ``i + 1`` (DFS);
* ``skip[i]`` is the node to visit when the AABB test fails, or after a
  leaf is processed; the sentinel ``num_nodes`` terminates traversal;
* leaves hold ``tri_count > 0`` triangles at ``tri_offset`` into the
  Morton-sorted primitive order; inner nodes have ``tri_count == 0``.

Triangle data is pre-swizzled into sorted leaf order (v0/e1/e2) so leaf
tests gather contiguously; ``prim_id`` maps back to the original ids.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

pytree = partial(dataclasses.dataclass, frozen=True)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@pytree
class BVH:
    """Flattened skip-link BVH + swizzled triangle soup (device arrays)."""

    node_min: jnp.ndarray  # (N, 3) f32
    node_max: jnp.ndarray  # (N, 3) f32
    node_skip: jnp.ndarray  # (N,) i32
    node_tri_offset: jnp.ndarray  # (N,) i32
    node_tri_count: jnp.ndarray  # (N,) i32 (0 = inner)
    tri_v0: jnp.ndarray  # (T, 3) f32, Morton-sorted order
    tri_e1: jnp.ndarray  # (T, 3) f32  (v1 - v0)
    tri_e2: jnp.ndarray  # (T, 3) f32  (v2 - v0)
    prim_id: jnp.ndarray  # (T,) i32 sorted slot -> original triangle id

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes (uint32)."""

    def expand(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(x) << 2 | expand(y) << 1 | expand(z)).astype(np.uint32)


def _build_ranges(total: int, leaf_size: int):
    """Iterative DFS over [start, end) ranges.

    Returns (start, end, skip, is_leaf) int64 arrays in DFS order.  The
    tree shape depends only on range lengths (median split), so subtree
    node counts are memoized and each left child's skip (its right
    sibling's root index) is known at push time.
    """

    @lru_cache(maxsize=None)
    def count(n: int) -> int:
        if n <= leaf_size:
            return 1
        return 1 + count(n // 2) + count(n - n // 2)

    n_nodes = count(total)
    start = np.empty(n_nodes, np.int64)
    end = np.empty(n_nodes, np.int64)
    skip = np.empty(n_nodes, np.int64)
    leaf = np.zeros(n_nodes, bool)

    stack = [(0, total, n_nodes)]  # (s, e, skip); root's skip = sentinel
    i = 0
    while stack:
        s, e, sk = stack.pop()
        start[i], end[i], skip[i] = s, e, sk
        ln = e - s
        if ln <= leaf_size:
            leaf[i] = True
        else:
            mid = s + ln // 2
            right_root = i + 1 + count(ln // 2)
            stack.append((mid, e, sk))  # right: inherits parent's skip
            stack.append((s, mid, right_root))  # left: skip -> right subtree
        i += 1
    assert i == n_nodes
    return start, end, skip, leaf


def _range_aabbs(start, end, leaf, skip, s_min, s_max, leaf_size):
    """AABBs for every node: leaves vectorized (bounded range length),
    inner nodes by one reverse child-merge pass (children of inner i are
    i+1 and skip[i+1])."""
    n = len(start)
    bmin = np.empty((n, 3), np.float32)
    bmax = np.empty((n, 3), np.float32)

    lidx = np.nonzero(leaf)[0]
    ls = start[lidx]
    le = end[lidx]
    lmin = np.full((len(lidx), 3), np.inf, np.float32)
    lmax = np.full((len(lidx), 3), -np.inf, np.float32)
    for k in range(leaf_size):
        valid = ls + k < le
        rows = np.minimum(ls + k, len(s_min) - 1)
        lmin = np.where(valid[:, None], np.minimum(lmin, s_min[rows]), lmin)
        lmax = np.where(valid[:, None], np.maximum(lmax, s_max[rows]), lmax)
    bmin[lidx] = lmin
    bmax[lidx] = lmax

    inner = np.nonzero(~leaf)[0]
    for i in inner[::-1]:  # reverse DFS: children already resolved
        l = i + 1
        r = skip[l]
        bmin[i] = np.minimum(bmin[l], bmin[r])
        bmax[i] = np.maximum(bmax[l], bmax[r])
    return bmin, bmax


def _bvh_from_arrays(arrs: dict) -> "BVH":
    """Upload the numpy build products (keys = _BVH_NP_FIELDS) once."""
    f32 = partial(jnp.asarray, dtype=jnp.float32)
    i32 = partial(jnp.asarray, dtype=jnp.int32)
    return BVH(
        node_min=f32(arrs["node_min"]),
        node_max=f32(arrs["node_max"]),
        node_skip=i32(arrs["node_skip"]),
        node_tri_offset=i32(arrs["node_tri_offset"]),
        node_tri_count=i32(arrs["node_tri_count"]),
        tri_v0=f32(arrs["tri_v0"]),
        tri_e1=f32(arrs["tri_e1"]),
        tri_e2=f32(arrs["tri_e2"]),
        prim_id=i32(arrs["prim_id"]),
    )


def _bvh_cache_key(tri_verts, leaf_size) -> str:
    """Content hash of everything that determines the build output."""
    import hashlib

    h = hashlib.sha1()
    h.update(b"bvhcache-v3")  # v3: skip-link nodes + triangle soup only
    h.update(np.int64(leaf_size).tobytes())
    h.update(np.ascontiguousarray(tri_verts).tobytes())
    return h.hexdigest()


_BVH_NP_FIELDS = (
    "node_min", "node_max", "node_skip", "node_tri_offset",
    "node_tri_count", "tri_v0", "tri_e1", "tri_e2", "prim_id",
)


def build_bvh_cached(cache_dir, tri_verts, leaf_size: int = 4) -> "BVH":
    """build_bvh with a content-addressed on-disk bake cache.

    Acceleration-structure baking, the production answer to rebuild
    latency (the reference rebuilds its TLAS/BLAS on the GPU every run,
    viewer.hpp:506-517; a host LBVH over 1M tris costs seconds of numpy
    here).  The cache key hashes the exact geometry + build parameters,
    so a stale cache is impossible by construction; entries are plain
    uncompressed .npz (load is IO-bound, ~0.5 s for a 1M-tri scene vs a
    multi-second rebuild).  ``cache_dir=None`` just builds.
    """
    import os

    if cache_dir is None:
        return build_bvh(tri_verts, leaf_size)
    tri_verts = np.asarray(tri_verts, np.float32)
    key = _bvh_cache_key(tri_verts, leaf_size)
    path = os.path.join(cache_dir, f"bvh-{key}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return _bvh_from_arrays({f: z[f] for f in _BVH_NP_FIELDS})
    arrs = build_bvh(tri_verts, leaf_size, _as_arrays=True)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrs)
    os.replace(tmp, path)  # atomic: concurrent renderers see all or nothing
    return _bvh_from_arrays(arrs)


def build_bvh(
    tri_verts: np.ndarray,
    leaf_size: int = 4,
    _as_arrays: bool = False,
) -> "BVH | dict":
    """Build from (T, 3, 3) float32 triangle vertices.

    ``_as_arrays=True`` returns the numpy build products instead of an
    uploaded BVH: the cacheable representation (build_bvh_cached), kept
    on the host so the cache never reads device memory back.
    """
    tri_verts = np.asarray(tri_verts, np.float32)
    T = tri_verts.shape[0]
    assert T > 0, "empty scene"

    tmin = tri_verts.min(axis=1)  # (T, 3)
    tmax = tri_verts.max(axis=1)
    centroid = 0.5 * (tmin + tmax)

    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-20)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int32)

    start, end, skip, leaf = _build_ranges(T, leaf_size)
    bmin, bmax = _range_aabbs(start, end, leaf, skip, tmin[order], tmax[order],
                              leaf_size)

    v0 = tri_verts[order, 0]
    arrs = {
        "node_min": bmin,
        "node_max": bmax,
        "node_skip": skip,
        "node_tri_offset": np.where(leaf, start, 0),
        "node_tri_count": np.where(leaf, end - start, 0),
        "tri_v0": v0,
        "tri_e1": tri_verts[order, 1] - v0,
        "tri_e2": tri_verts[order, 2] - v0,
        "prim_id": order,
    }
    return arrs if _as_arrays else _bvh_from_arrays(arrs)
