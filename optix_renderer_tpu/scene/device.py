"""Device scene: flat SoA arrays uploaded once per scene.

The reference binds per-mesh SBT records (``TriangleMeshData``,
cuda_include/common.cuh:130-151) and a TLAS of per-mesh BLASes; here the
design is one flat, globally-indexed geometry pool: traversal
returns a triangle id, and the former closest-hit program
(hit_miss.cuh:14-50) becomes a vectorized gather over these arrays keyed
by ``tri_mesh_id[tri]``.  Everything is shape-static and replicated per
device (scene data for Cornell/Sponza-class scenes fits device memory
comfortably).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import Scene

pytree = partial(dataclasses.dataclass, frozen=True)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@pytree
class TextureAtlas:
    """All textures packed into one flat pixel pool (bilinear filtering is
    done with explicit gathers, not texture units)."""

    pixels: jnp.ndarray  # (P, 4) float32 in [0,1], row-major per texture, row 0 = bottom
    offset: jnp.ndarray  # (K,) int32 start of texture k in pixels
    width: jnp.ndarray  # (K,) int32
    height: jnp.ndarray  # (K,) int32


@_register
@pytree
class DeviceScene:
    """Flat scene pool + light lists + LTC-independent material tables."""

    # geometry (all meshes concatenated; indices are global)
    vertices: jnp.ndarray  # (V, 3) f32
    normals: jnp.ndarray  # (V, 3) f32
    uvs: jnp.ndarray  # (V, 2) f32
    tri_index: jnp.ndarray  # (T, 3) i32 into vertices/normals/uvs
    tri_mesh: jnp.ndarray  # (T,) i32 mesh id per triangle

    # per-mesh material table (TriangleMeshData equivalent)
    mesh_diffuse: jnp.ndarray  # (M, 3)
    mesh_alpha: jnp.ndarray  # (M,)
    mesh_emit: jnp.ndarray  # (M, 3)
    mesh_is_light: jnp.ndarray  # (M,) bool
    mesh_material_id: jnp.ndarray  # (M,) i32
    mesh_diffuse_tex: jnp.ndarray  # (M,) i32 atlas id or -1
    mesh_alpha_tex: jnp.ndarray  # (M,) i32
    mesh_normal_tex: jnp.ndarray  # (M,) i32

    # area lights (TriLight list, viewer.hpp:236-265 semantics)
    light_v1: jnp.ndarray  # (L, 3)
    light_v2: jnp.ndarray  # (L, 3)
    light_v3: jnp.ndarray  # (L, 3)
    light_cg: jnp.ndarray  # (L, 3)
    light_normal: jnp.ndarray  # (L, 3)
    light_emit: jnp.ndarray  # (L, 3)
    light_area: jnp.ndarray  # (L,)

    # mesh lights (MeshLight bookkeeping, common.cuh:74-78)
    mesh_light_tri_idx: jnp.ndarray  # (ML,) i32 first TriLight of mesh
    mesh_light_tri_count: jnp.ndarray  # (ML,) i32

    textures: TextureAtlas
    miss_color: jnp.ndarray  # (3,) miss program const_color (common.cuh:153-155)

    # packed per-triangle attribute matrix (T, PACK_K): one one-hot
    # matmul gathers *all* shading attributes for small scenes at once
    # (engine.shade dispatches on num_tris). Layout: PACK_SLICES below.
    tri_pack: jnp.ndarray

    @property
    def num_tris(self) -> int:
        return self.tri_index.shape[0]

    @property
    def has_textures(self) -> bool:
        """Static (shape-based): any real texture in the atlas?"""
        return self.textures.pixels.shape[0] > 1

    @property
    def num_lights(self) -> int:
        return self.light_v1.shape[0]


# largest scene (tris) that uses the packed one-hot attribute gather
# (engine.shade dispatches to flat gathers above this)
ONEHOT_MAX_TRIS = 4096

# tri_pack column layout (end-exclusive): see build_device_scene
PACK_SLICES = {
    "v1": (0, 3), "v2": (3, 6), "v3": (6, 9),
    "n1": (9, 12), "n2": (12, 15), "n3": (15, 18),
    "uv1": (18, 20), "uv2": (20, 22), "uv3": (22, 24),
    "diffuse": (24, 27), "emit": (27, 30),
    "alpha": (30, 31), "is_light": (31, 32), "material_id": (32, 33),
    "area": (33, 34), "diffuse_tex": (34, 35),
}
PACK_K = 35


def build_texture_atlas(textures) -> TextureAtlas:
    if not textures:
        return TextureAtlas(
            pixels=jnp.ones((1, 4), jnp.float32),
            offset=jnp.zeros((1,), jnp.int32),
            width=jnp.ones((1,), jnp.int32),
            height=jnp.ones((1,), jnp.int32),
        )
    offsets, widths, heights, pools = [], [], [], []
    off = 0
    for t in textures:
        h, w = t.pixels.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        pools.append(t.pixels.reshape(-1, 4))
        off += h * w
    return TextureAtlas(
        pixels=jnp.asarray(np.concatenate(pools, axis=0), jnp.float32),
        offset=jnp.asarray(offsets, jnp.int32),
        width=jnp.asarray(widths, jnp.int32),
        height=jnp.asarray(heights, jnp.int32),
    )


def build_device_scene(
    scene: Scene, miss_color=(0.0, 0.0, 0.0), return_host: bool = False
):
    """Flatten a host Scene into device arrays.

    Light list construction matches viewer.hpp:236-265: per light mesh,
    per triangle — v1/v2/v3 from the index, cg = mean, normal =
    normalize(n1+n2+n3), area = 0.5|cross(v1-v2, v3-v2)|, emit = mesh emit.

    ``return_host=True`` additionally returns the flat host (numpy)
    geometry arrays {vertices, normals, uvs, tri_index, tri_mesh} so
    host-side consumers (the BVH builder) never read back what was just
    uploaded.
    """
    meshes = scene.model.meshes
    verts, norms, uvs, tris, tri_mesh = [], [], [], [], []
    v_off = 0
    for mid, m in enumerate(meshes):
        verts.append(m.vertex)
        norms.append(m.normal)
        uvs.append(m.texcoord)
        tris.append(m.index.astype(np.int64) + v_off)
        tri_mesh.append(np.full(len(m.index), mid, np.int32))
        v_off += len(m.vertex)

    # TriLight list from the light meshes (they are also appended to the
    # model by sync_lights, so they are hittable geometry too).
    lv1, lv2, lv3, lcg, lnormal, lemit, larea = [], [], [], [], [], [], []
    ml_idx, ml_count = [], []
    for light in scene.tri_lights.meshes:
        ml_idx.append(len(lv1))
        n_tri = 0
        for idx in light.index:
            v1 = light.vertex[idx[0]]
            v2 = light.vertex[idx[1]]
            v3 = light.vertex[idx[2]]
            lv1.append(v1)
            lv2.append(v2)
            lv3.append(v3)
            lcg.append((v1 + v2 + v3) / 3.0)
            n = light.normal[idx[0]] + light.normal[idx[1]] + light.normal[idx[2]]
            lnormal.append(n / max(np.linalg.norm(n), 1e-20))
            larea.append(0.5 * np.linalg.norm(np.cross(v1 - v2, v3 - v2)))
            lemit.append(light.emit)
            n_tri += 1
        ml_count.append(n_tri)

    f32 = partial(jnp.asarray, dtype=jnp.float32)
    i32 = partial(jnp.asarray, dtype=jnp.int32)

    # pack per-triangle shading attributes (gathered once on host)
    all_v = np.concatenate(verts, axis=0)
    all_n = np.concatenate(norms, axis=0)
    all_uv = np.concatenate(uvs, axis=0)
    all_tri = np.concatenate(tris, axis=0)
    all_mesh = np.concatenate(tri_mesh, axis=0)
    mesh_diffuse_np = np.stack([m.diffuse for m in meshes]).astype(np.float32)
    mesh_alpha_np = np.asarray([m.alpha for m in meshes], np.float32)
    mesh_emit_np = np.stack([m.emit for m in meshes]).astype(np.float32)
    mesh_is_light_np = np.asarray([m.is_light for m in meshes], np.float32)
    mesh_matid_np = np.asarray([m.material_id for m in meshes], np.float32)
    mesh_dtex_np = np.asarray([m.diffuse_texture_id for m in meshes], np.float32)
    # tri_pack feeds only the small-scene one-hot gather (engine.shade
    # dispatches away from it above ONEHOT_MAX_TRIS); don't pay the ~140MB
    # upload for big scenes.
    if len(all_tri) <= ONEHOT_MAX_TRIS:
        tv1, tv2, tv3 = (all_v[all_tri[:, k]] for k in range(3))
        tn1, tn2, tn3 = (all_n[all_tri[:, k]] for k in range(3))
        tu1, tu2, tu3 = (all_uv[all_tri[:, k]] for k in range(3))
        tri_area = 0.5 * np.linalg.norm(np.cross(tv1 - tv2, tv3 - tv2), axis=-1)
        tri_pack = np.concatenate(
            [
                tv1, tv2, tv3, tn1, tn2, tn3, tu1, tu2, tu3,
                mesh_diffuse_np[all_mesh], mesh_emit_np[all_mesh],
                mesh_alpha_np[all_mesh][:, None], mesh_is_light_np[all_mesh][:, None],
                mesh_matid_np[all_mesh][:, None], tri_area[:, None].astype(np.float32),
                mesh_dtex_np[all_mesh][:, None],
            ],
            axis=1,
        ).astype(np.float32)
        assert tri_pack.shape[1] == PACK_K
    else:
        tri_pack = np.zeros((1, PACK_K), np.float32)

    ds = DeviceScene(
        tri_pack=f32(tri_pack),
        vertices=f32(all_v),
        normals=f32(all_n),
        uvs=f32(all_uv),
        tri_index=i32(all_tri),
        tri_mesh=i32(all_mesh),
        mesh_diffuse=f32(np.stack([m.diffuse for m in meshes])),
        mesh_alpha=f32(np.asarray([m.alpha for m in meshes])),
        mesh_emit=f32(np.stack([m.emit for m in meshes])),
        mesh_is_light=jnp.asarray([m.is_light for m in meshes], jnp.bool_),
        mesh_material_id=i32(np.asarray([m.material_id for m in meshes])),
        mesh_diffuse_tex=i32(np.asarray([m.diffuse_texture_id for m in meshes])),
        mesh_alpha_tex=i32(np.asarray([m.alpha_texture_id for m in meshes])),
        mesh_normal_tex=i32(np.asarray([m.normal_texture_id for m in meshes])),
        light_v1=f32(np.stack(lv1) if lv1 else np.zeros((0, 3))),
        light_v2=f32(np.stack(lv2) if lv2 else np.zeros((0, 3))),
        light_v3=f32(np.stack(lv3) if lv3 else np.zeros((0, 3))),
        light_cg=f32(np.stack(lcg) if lcg else np.zeros((0, 3))),
        light_normal=f32(np.stack(lnormal) if lnormal else np.zeros((0, 3))),
        light_emit=f32(np.stack(lemit) if lemit else np.zeros((0, 3))),
        light_area=f32(np.asarray(larea) if larea else np.zeros((0,))),
        mesh_light_tri_idx=i32(np.asarray(ml_idx)),
        mesh_light_tri_count=i32(np.asarray(ml_count)),
        textures=build_texture_atlas(scene.model.textures),
        miss_color=f32(np.asarray(miss_color)),
    )
    if return_host:
        host = dict(
            vertices=all_v.astype(np.float32),
            normals=all_n.astype(np.float32),
            uvs=all_uv.astype(np.float32),
            tri_index=all_tri.astype(np.int64),
            tri_mesh=all_mesh.astype(np.int32),
        )
        return ds, host
    return ds
