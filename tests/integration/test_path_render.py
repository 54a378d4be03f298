"""BASELINE config 2: path tracing — statistical tests against the
independent numpy MC oracle, convergence behaviour, multi-bounce sanity."""

import numpy as np
import pytest

from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene

from tests.oracles import path_oracle as oracle


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell")
    return parse_scene(procedural.write_cornell_scene(str(d)))


def render_mean(scene, depth, spp, size=48):
    r = Renderer(scene, width=size, height=size, mode=RendererType.PATH, path_depth=depth)
    r.render(spp)
    return r, r.image()


@pytest.mark.slow
def test_direct_matches_oracle(scene):
    """depth=1 (direct MIS) at exact surface points: the framework's
    estimator averaged over many RNG lanes vs the independent float64
    oracle at the same point (no pixel-footprint integration)."""
    import jax.numpy as jnp

    from optix_renderer_tpu.core import rng as rnglib
    from optix_renderer_tpu.core.types import Ray, SurfaceInteraction
    from optix_renderer_tpu.integrators.path import path_color

    size = 48
    r, img = render_mean(scene, depth=1, spp=4, size=size)
    gb = r.gbuffers
    pos = np.asarray(gb.position)
    nrm = np.asarray(gb.normal)
    alb = np.asarray(gb.albedo)
    alpha_b = np.asarray(gb.alpha)
    mat = np.asarray(gb.material_id)
    ds = r.device_scene
    tris = np.asarray(ds.vertices, np.float64)[np.asarray(ds.tri_index)]
    tri_mesh = np.asarray(ds.tri_mesh)
    mesh_is_light = np.asarray(ds.mesh_is_light)
    mesh_emit = np.asarray(ds.mesh_emit, np.float64)
    tri_is_light = mesh_is_light[tri_mesh]
    tri_emit = mesh_emit[tri_mesh]
    lights = dict(
        v1=np.asarray(ds.light_v1, np.float64),
        v2=np.asarray(ds.light_v2, np.float64),
        v3=np.asarray(ds.light_v3, np.float64),
        normal=np.asarray(ds.light_normal, np.float64),
        emit=np.asarray(ds.light_emit, np.float64),
        area=np.asarray(ds.light_area, np.float64),
    )
    cam = np.asarray(r.state.camera.pos, np.float64)

    def estimate_at_point(p, n, albedo, alpha, n_lanes=16384, seed=0):
        """Framework estimator at one fixed point, averaged over RNG lanes."""
        m = n_lanes
        f32 = lambda v: jnp.asarray(np.tile(np.asarray(v, np.float32), (m, 1)))  # noqa: E731
        si = SurfaceInteraction(
            hit=jnp.ones(m, bool),
            p=f32(p),
            uv=jnp.zeros((m, 2), jnp.float32),
            n_geom=f32(n),
            diffuse=f32(albedo),
            alpha=jnp.full(m, alpha, jnp.float32),
            emit=jnp.zeros((m, 3), jnp.float32),
            is_light=jnp.zeros(m, bool),
            material_id=jnp.ones(m, jnp.int32),
            area=jnp.ones(m, jnp.float32),
        )
        rays = Ray(origin=f32(cam), direction=f32([0.0, 0.0, 1.0]))
        rstate = rnglib.make_rng(seed, jnp.arange(m, dtype=jnp.uint32))
        color, _, _ = path_color(ds, r.bvh, rays, si, rstate, max_depth=1)
        c = np.asarray(color)
        return c.mean(0), c.std(0) / np.sqrt(m)

    rr = np.random.default_rng(11)
    checked = 0
    for k in range(60):
        y, x = int(rr.integers(4, size - 4)), int(rr.integers(4, size - 4))
        if mat[y, x] == 0:
            continue
        p = pos[y, x].astype(np.float64)
        n = nrm[y, x].astype(np.float64)
        want, w_err = oracle.direct_lighting_mc(
            p, n, alb[y, x].astype(np.float64), float(alpha_b[y, x]), cam,
            tris, tri_is_light, tri_emit, lights, n_samples=20000, seed=k,
        )
        got, g_err = estimate_at_point(p, n, alb[y, x], float(alpha_b[y, x]), seed=k)
        tol = 5 * (w_err + g_err) + 0.02 * np.abs(want) + 1e-4
        assert (np.abs(got - want) < tol).all(), (x, y, got, want, w_err, g_err)
        checked += 1
        if checked >= 12:
            break
    assert checked >= 12


@pytest.mark.slow
def test_variance_decreases_with_spp(scene):
    """RMSE between two independent halves shrinks ~1/sqrt(spp)."""
    size = 32
    r1 = Renderer(scene, width=size, height=size, mode=RendererType.PATH, path_depth=2)
    r1.render(16)
    a16 = r1.image()
    r1.render(48)
    a64 = r1.image()
    r2 = Renderer(scene, width=size, height=size, mode=RendererType.PATH, path_depth=2)
    # decorrelate via camera reset + skipping frames differs... use separate
    # renderer with same camera: identical seeds -> same stream; instead use
    # the converged 256-frame mean as pseudo-ground-truth
    r2.render(256)
    ref = r2.image()
    rmse16 = np.sqrt(((a16 - ref) ** 2).mean())
    rmse64 = np.sqrt(((a64 - ref) ** 2).mean())
    assert rmse64 < rmse16 * 0.75  # should be ~0.5, allow slack


@pytest.mark.slow
def test_multibounce_adds_energy(scene):
    _, d1 = render_mean(scene, depth=1, spp=64, size=32)
    _, d3 = render_mean(scene, depth=3, spp=64, size=32)
    assert np.isfinite(d3).all()
    # indirect light adds energy on average
    assert d3.mean() > d1.mean() * 1.05
    # block faces that are black under direct-only get indirect light
    # (any pixel that was ~EPS should now be brighter somewhere)
    dark = d1.sum(-1) < 1e-3
    if dark.any():
        assert d3.sum(-1)[dark].mean() > 1e-3


def test_light_pixels_show_emission(scene):
    _, img = render_mean(scene, depth=1, spp=1, size=32)
    assert img.max() >= 16.9  # light quad visible at the top


def test_multiframe_scan_matches_stepwise(scene):
    """render(n) runs n-1 frames as an in-jit lax.scan; it must be
    bit-identical to n separate render(1) calls (RNG is keyed by the
    carried accum_id)."""
    from optix_renderer_tpu.engine.renderer import Renderer

    a = Renderer(scene, width=32, height=32, mode=RendererType.PATH, path_depth=3)
    b = Renderer(scene, width=32, height=32, mode=RendererType.PATH, path_depth=3)
    a.render(4)
    for _ in range(4):
        b.render(1)
    assert int(a.state.accum_id) == int(b.state.accum_id) == 4
    np.testing.assert_array_equal(np.asarray(a.state.accum), np.asarray(b.state.accum))
    # honest ray accounting agrees too
    assert a.metrics["rays_traced"] == b.metrics["rays_traced"]
