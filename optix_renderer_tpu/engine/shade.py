"""Hit shading stage: Hit -> SurfaceInteraction via vectorized gathers.

The equivalent of the reference's closest-hit + miss programs
(cuda_include/hit_miss.cuh:14-63): after traversal returns (tri_id, bary),
gather triangle attributes and interpolate.

Two lowerings, dispatched statically on scene size:

* small scenes (<= ONEHOT_MAX_TRIS): ALL per-triangle attributes live in
  one packed (T, K) matrix (scene.device.tri_pack) and the gather is a
  single one-hot (R, T) @ (T, K) matmul;
* large scenes: direct dynamic gathers over the flat pools.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..core.types import Hit, Ray, SurfaceInteraction
from ..scene.device import ONEHOT_MAX_TRIS, PACK_SLICES, DeviceScene
from ..scene.textures import sample_bilinear


def _finalize(ds, rays, hit, parts, miss_color):
    """Assemble the SurfaceInteraction from gathered per-lane attributes,
    applying the miss program semantics (hit_miss.cuh:52-63)."""
    valid = hit.tri_id >= 0
    u = hit.bary_u[:, None]
    v = hit.bary_v[:, None]
    w = 1.0 - u - v

    p = w * parts["v1"] + u * parts["v2"] + v * parts["v3"]  # utils.cuh:9-18
    n_geom = cm.normalize(w * parts["n1"] + u * parts["n2"] + v * parts["n3"], eps=1e-30)
    uv = w * parts["uv1"] + u * parts["uv2"] + v * parts["uv3"]
    uv = jnp.abs(jnp.fmod(uv, 1.0))  # hit_miss.cuh:34-35

    diffuse = parts["diffuse"]
    if ds.has_textures:  # static: skip atlas sampling entirely if no textures
        tex_id = parts["diffuse_tex"].astype(jnp.int32)
        has_tex = tex_id >= 0
        tex_rgba = sample_bilinear(ds.textures, tex_id, uv[:, 0], uv[:, 1])
        diffuse = jnp.where(has_tex[:, None], tex_rgba[:, :3], diffuse)  # hit_miss.cuh:40-44

    alpha = jnp.clip(parts["alpha"], 0.01, 1.0)  # hit_miss.cuh:45-46

    vmask = valid[:, None]
    zero3 = jnp.zeros_like(p)
    return SurfaceInteraction(
        hit=valid,
        p=jnp.where(vmask, p, zero3),
        uv=jnp.where(vmask, uv, 0.0),
        n_geom=jnp.where(vmask, n_geom, zero3),
        diffuse=jnp.where(vmask, diffuse, miss_color[None, :]),
        alpha=jnp.where(valid, alpha, 0.0),
        emit=jnp.where(vmask, parts["emit"], zero3),
        is_light=valid & parts["is_light"],
        material_id=jnp.where(valid, parts["material_id"].astype(jnp.int32), 0),
        area=jnp.where(valid, parts["area"], 0.0),
    )


def _shade_onehot(ds: DeviceScene, rays: Ray, hit: Hit, miss_color) -> SurfaceInteraction:
    """One (R, T) one-hot matmul gathers the whole packed attribute row."""
    T = ds.num_tris
    tid = jnp.maximum(hit.tri_id, 0)
    onehot = (tid[:, None] == jnp.arange(T, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    # Precision.HIGHEST: a reduced-precision matmul (bf16 or TF32) would
    # round every gathered attribute (hit positions of ~500-unit scenes
    # get ~1.0 absolute error, larger than the shadow-ray epsilon).
    rows = jnp.dot(
        onehot, ds.tri_pack,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (R, K)

    def take(name):
        a, b = PACK_SLICES[name]
        return rows[:, a:b] if b - a > 1 else rows[:, a]

    parts = {k: take(k) for k in ("v1", "v2", "v3", "n1", "n2", "n3", "uv1", "uv2", "uv3", "diffuse", "emit", "diffuse_tex")}
    parts.update(
        alpha=take("alpha"),
        is_light=take("is_light") > 0.5,
        material_id=take("material_id"),
        area=take("area"),
    )
    return _finalize(ds, rays, hit, parts, miss_color)


def _shade_gather(ds: DeviceScene, rays: Ray, hit: Hit, miss_color) -> SurfaceInteraction:
    """Direct dynamic gathers over the flat pools (large scenes)."""
    tid = jnp.maximum(hit.tri_id, 0)
    idx = ds.tri_index[tid]  # (N, 3)
    mesh = ds.tri_mesh[tid]  # (N,)
    parts = dict(
        v1=ds.vertices[idx[:, 0]],
        v2=ds.vertices[idx[:, 1]],
        v3=ds.vertices[idx[:, 2]],
        n1=ds.normals[idx[:, 0]],
        n2=ds.normals[idx[:, 1]],
        n3=ds.normals[idx[:, 2]],
        uv1=ds.uvs[idx[:, 0]],
        uv2=ds.uvs[idx[:, 1]],
        uv3=ds.uvs[idx[:, 2]],
        diffuse=ds.mesh_diffuse[mesh],
        emit=ds.mesh_emit[mesh],
        diffuse_tex=ds.mesh_diffuse_tex[mesh].astype(jnp.float32),
        alpha=ds.mesh_alpha[mesh],
        is_light=ds.mesh_is_light[mesh],
        material_id=ds.mesh_material_id[mesh].astype(jnp.float32),
        area=cm.triangle_area(ds.vertices[idx[:, 0]], ds.vertices[idx[:, 1]], ds.vertices[idx[:, 2]]),
    )
    return _finalize(ds, rays, hit, parts, miss_color)


def build_surface_interaction(
    ds: DeviceScene, rays: Ray, hit: Hit, miss_color: jnp.ndarray | None = None
) -> SurfaceInteraction:
    """Interpolate attributes at hit points (hit_miss.cuh:14-50); fill miss
    lanes like the miss program (hit_miss.cuh:52-63)."""
    if miss_color is None:
        miss_color = ds.miss_color
    if ds.num_tris <= ONEHOT_MAX_TRIS:
        return _shade_onehot(ds, rays, hit, miss_color)
    return _shade_gather(ds, rays, hit, miss_color)


def trace_closest_si(
    ds: DeviceScene, bvh, rays: Ray, miss_color: jnp.ndarray | None = None,
    active: jnp.ndarray | None = None,
) -> SurfaceInteraction:
    """Trace + shade in one step (the single entry point integrators use).

    ``active`` (bool (N,), optional): lanes the caller will mask out
    anyway (dead path lanes).  They are traced with t_max = 0, so they
    return miss and the walk skips them.
    """
    from ..accel.traverse import _INF, trace_closest

    t_max = _INF if active is None else jnp.where(active, _INF, 0.0)
    hit = trace_closest(bvh, rays, t_max=t_max)
    return build_surface_interaction(ds, rays, hit, miss_color)
