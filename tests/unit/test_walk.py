"""Skip-link walk tier (scenes above BRUTE_MAX_TRIS) against the brute
oracle on real big scenes, the size-only tier choice, and shading from
walk hits."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.accel import traverse
from optix_renderer_tpu.accel.build import build_bvh, build_bvh_cached
from optix_renderer_tpu.accel.traverse import (
    BRUTE_MAX_TRIS,
    intersect_brute,
    trace_any,
    trace_closest,
)
from optix_renderer_tpu.core import rng as rnglib
from optix_renderer_tpu.core.types import Hit, Ray
from optix_renderer_tpu.engine import camera as cameralib
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer
from optix_renderer_tpu.engine.shade import _shade_gather, trace_closest_si
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene

W = H = 32


def _camera_rays(r):
    lin = jnp.arange(W * H, dtype=jnp.uint32)
    rs = rnglib.make_rng(10007, lin)
    rs, ju = rnglib.lcg_randomf(rs)
    rs, jv = rnglib.lcg_randomf(rs)
    return cameralib.primary_rays(r.state.camera, W, H, ju, jv, lin=lin)


def _scattered_rays(r, n=1000, seed=7):
    """Incoherent rays from random points above the scene (bounce-like)."""
    v = np.asarray(r.bvh.tri_v0)
    lo, hi = v.min(axis=0), v.max(axis=0)
    rng = np.random.default_rng(seed)
    o = lo + rng.random((n, 3), np.float32) * (hi - lo)
    o[:, 1] = hi[1] * 1.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray(origin=jnp.asarray(o, jnp.float32), direction=jnp.asarray(d))


_SCENES = {
    # ~7k tris
    "terrain7k": lambda d: procedural.write_terrain_scene(d, grid=60, width=W, height=H),
    # ~10k tris
    "terrain10k": lambda d: procedural.write_terrain_scene(d, grid=72, width=W, height=H),
    # 5,670 tris, textured, smooth normals, 37 meshes
    "gallery": lambda d: procedural.write_gallery_scene(d, width=W, height=H),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name, write in _SCENES.items():
        scene = parse_scene(write(str(tmp_path_factory.mktemp(name))))
        r = Renderer(scene, width=W, height=H, mode=RendererType.MASK)
        assert r.device_scene.num_tris > BRUTE_MAX_TRIS  # the walk tier
        out[name] = r
    return out


def _oracle(r, rays, t_max=traverse._INF):
    tris = np.asarray(r.device_scene.vertices)[np.asarray(r.device_scene.tri_index)]
    return intersect_brute(jnp.asarray(tris), rays, t_max=t_max)


@pytest.mark.parametrize("name", list(_SCENES))
@pytest.mark.parametrize("rays_kind", ["camera", "scattered"])
def test_walk_closest_matches_brute(scenes, name, rays_kind):
    r = scenes[name]
    rays = _camera_rays(r) if rays_kind == "camera" else _scattered_rays(r)
    got = trace_closest(r.bvh, rays)
    want = _oracle(r, rays)
    gi, wi = np.asarray(got.tri_id), np.asarray(want.tri_id)
    np.testing.assert_array_equal(gi >= 0, wi >= 0)
    m = wi >= 0
    assert m.mean() > (0.5 if rays_kind == "camera" else 0.1)
    assert (gi == wi).mean() > 0.999  # only exact t ties may differ
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(_SCENES))
def test_walk_any_hit_per_ray_tmax(scenes, name):
    """Occlusion with a per-ray t_max, including t_max = 0 (dead lanes)."""
    r = scenes[name]
    rays = _scattered_rays(r, seed=23)
    n = rays.origin.shape[0]
    v = np.asarray(r.bvh.tri_v0)
    scale = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))
    rng = np.random.default_rng(5)
    t_max = (rng.random(n, np.float32) * scale).astype(np.float32)
    t_max[::5] = 0.0
    occ = np.asarray(trace_any(r.bvh, rays, t_max=jnp.asarray(t_max)))
    want = _oracle(r, rays)
    wt = np.asarray(want.t)
    want_occ = (np.asarray(want.tri_id) >= 0) & (wt < t_max)
    clear = np.abs(wt - t_max) > 1e-4 * np.maximum(t_max, 1.0)
    assert want_occ[clear].mean() > 0.05  # the case is non-trivial
    assert not occ[t_max == 0.0].any()
    assert (occ[clear] == want_occ[clear]).all()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_inactive_lanes_miss(scenes, query):
    """Lanes with t_max = 0 (the `active` mask) return miss on the walk."""
    r = scenes["terrain7k"]
    rays = _camera_rays(r)
    n = rays.origin.shape[0]
    active = np.arange(n) % 3 != 0
    t_max = jnp.where(jnp.asarray(active), traverse._INF, 0.0)
    if query == "closest":
        hit = trace_closest(r.bvh, rays, t_max=t_max)
        ids = np.asarray(hit.tri_id)
        assert (ids[~active] == -1).all()
        np.testing.assert_array_equal(
            ids[active], np.asarray(trace_closest(r.bvh, rays).tri_id)[active])
        si = trace_closest_si(r.device_scene, r.bvh, rays, active=jnp.asarray(active))
        assert not np.asarray(si.hit)[~active].any()
        assert np.asarray(si.hit)[active].mean() > 0.5
    else:
        occ = np.asarray(trace_any(r.bvh, rays, t_max=t_max))
        assert not occ[~active].any()
        assert occ[active].mean() > 0.5


_SHADE_FIELDS = ("p", "n_geom", "uv", "diffuse", "emit", "alpha", "material_id",
                 "is_light", "area")


@pytest.fixture(scope="module")
def gallery_si(scenes):
    """Surface interactions from walk hits and from brute-oracle hits."""
    r = scenes["gallery"]
    ds = r.device_scene
    assert ds.has_textures
    rays = _camera_rays(r)
    si_walk = trace_closest_si(ds, r.bvh, rays)
    want = _oracle(r, rays)
    si_ref = _shade_gather(ds, rays, Hit(t=want.t, tri_id=want.tri_id,
                                         bary_u=want.bary_u, bary_v=want.bary_v),
                           ds.miss_color)
    return si_walk, si_ref


@pytest.mark.parametrize("field", _SHADE_FIELDS)
def test_gallery_shading_from_walk_hits(gallery_si, field):
    """Interpolated normals, uvs, textures and material rows from walk
    hits equal the gather path on oracle hits (hit_miss.cuh:14-50)."""
    si_walk, si_ref = gallery_si
    m = np.asarray(si_ref.hit)
    assert m.mean() > 0.8
    np.testing.assert_array_equal(np.asarray(si_walk.hit), m)
    got = np.asarray(getattr(si_walk, field))[m]
    want = np.asarray(getattr(si_ref, field))[m]
    if got.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    if field == "diffuse":  # textures really sampled: the checker varies
        assert got.std(axis=0).max() > 0.05


@pytest.mark.parametrize("n_tris,tier", [(BRUTE_MAX_TRIS, "brute"),
                                         (BRUTE_MAX_TRIS + 1, "walk")])
@pytest.mark.parametrize("query", ["closest", "any"])
def test_tier_chosen_by_size(monkeypatch, n_tris, tier, query):
    calls = []
    for fn in ("trace_closest_brute", "trace_closest_bvh",
               "trace_any_brute", "trace_any_bvh"):
        orig = getattr(traverse, fn)
        monkeypatch.setattr(traverse, fn, lambda *a, _f=fn, _o=orig, **k: (
            calls.append(_f), _o(*a, **k))[1])
    rng = np.random.default_rng(n_tris)
    tris = rng.random((n_tris, 3, 3)).astype(np.float32)
    rays = Ray(origin=jnp.zeros((8, 3)), direction=jnp.ones((8, 3)) / np.sqrt(3.0))
    bvh = build_bvh(tris)
    (trace_closest if query == "closest" else trace_any)(bvh, rays)
    assert calls == [f"trace_{query}_{'brute' if tier == 'brute' else 'bvh'}"]


@pytest.mark.parametrize("cached", [False, True])
def test_nodes_built_for_walk_scenes(tmp_path, cached):
    """Above the brute cutoff every build carries the skip-link tree."""
    rng = np.random.default_rng(2)
    tris = rng.random((BRUTE_MAX_TRIS + 1, 3, 3)).astype(np.float32)
    bvh = (build_bvh_cached(str(tmp_path), tris) if cached else build_bvh(tris))
    assert bvh.num_nodes >= (BRUTE_MAX_TRIS + 1) // 4
    assert int(np.asarray(bvh.node_tri_count).sum()) == BRUTE_MAX_TRIS + 1
    if cached:  # and the cache hit returns the same tree
        again = build_bvh_cached(str(tmp_path), tris)
        for f in dataclasses.fields(bvh):
            np.testing.assert_array_equal(np.asarray(getattr(bvh, f.name)),
                                          np.asarray(getattr(again, f.name)))
