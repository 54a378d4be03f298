"""Multi-chip image-tile sharding: bit-identical to single-chip (SURVEY §4),
on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import pytest

from optix_renderer_tpu.core.types import RenderState
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer
from optix_renderer_tpu.parallel import sharding
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell")
    return parse_scene(procedural.write_cornell_scene(str(d)))


@pytest.mark.parametrize(
    "mode,depth",
    [
        (RendererType.DIFFUSE, 1),
        pytest.param(RendererType.PATH, 2, marks=pytest.mark.slow),  # heavy compile
    ],
)
def test_sharded_bit_identical(scene, mode, depth):
    assert len(jax.devices()) >= 8, "conftest must force 8 host devices"
    W = H = 32

    # single-chip reference (deterministic modes early-stop at 1 frame, so
    # drive the frame function directly for an exact frame count)
    ref = Renderer(scene, width=W, height=H, mode=mode, path_depth=depth)
    ref_state, ref_gb = ref.state, None
    for _ in range(2):
        ref_state, ref_gb, _ = ref._frame(ref_state, ref.device_scene, ref.bvh)
    ref_img = np.asarray(ref_state.accum)

    # 8-way sharded
    mesh = sharding.make_mesh(8)
    r = Renderer(scene, width=W, height=H, mode=mode, path_depth=depth)
    frame = sharding.make_sharded_frame_fn(mesh, mode, W, H, path_depth=depth)
    state = sharding.shard_render_state(r.state, mesh)
    ds = sharding.replicate(r.device_scene, mesh)
    bvh = sharding.replicate(r.bvh, mesh)
    for _ in range(2):
        state, gb, aux = frame(state, ds, bvh)

    got = np.asarray(state.accum)
    # pure data parallelism + absolute pixel RNG streams: identical up to
    # single-ulp fusion differences between the two XLA compilations
    np.testing.assert_allclose(got, ref_img, rtol=0, atol=2e-6)
    assert (got == ref_img).mean() > 0.99
    np.testing.assert_allclose(
        np.asarray(gb.position), np.asarray(ref_gb.position), rtol=0, atol=2e-4
    )


def test_sharded_state_stays_sharded(scene):
    mesh = sharding.make_mesh(8)
    W = H = 16
    r = Renderer(scene, width=W, height=H, mode=RendererType.MASK)
    frame = sharding.make_sharded_frame_fn(mesh, RendererType.MASK, W, H)
    state = sharding.shard_render_state(r.state, mesh)
    ds = sharding.replicate(r.device_scene, mesh)
    bvh = sharding.replicate(r.bvh, mesh)
    state, _, _ = frame(state, ds, bvh)
    assert isinstance(state, RenderState)
    shard_shapes = {s.data.shape for s in state.accum.addressable_shards}
    assert shard_shapes == {(2, 16, 3)}  # 16 rows / 8 devices


def test_sharded_big_scene_terrain(tmp_path):
    """BASELINE config 5 wiring: a >4096-triangle scene (the BVH-walk
    tier) renders row-sharded over the virtual mesh, bit-identical to a
    single device."""
    import numpy as np

    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.parallel import sharding
    from optix_renderer_tpu.scene import procedural
    from optix_renderer_tpu.scene.config import parse_scene

    scene = parse_scene(procedural.write_terrain_scene(str(tmp_path), grid=60))
    W, H = 32, 64
    r = Renderer(scene, width=W, height=H, mode=RendererType.NORMALS)
    assert r.device_scene.num_tris > 4096
    r.render(1)
    single = r.image()

    n_dev = len(jax.devices())
    mesh = sharding.make_mesh(n_dev)
    r2 = Renderer(scene, width=W, height=H, mode=RendererType.NORMALS)
    frame = sharding.make_sharded_frame_fn(mesh, RendererType.NORMALS, W, H, path_depth=1)
    state = sharding.shard_render_state(r2.state, mesh)
    ds = sharding.replicate(r2.device_scene, mesh)
    bvh = sharding.replicate(r2.bvh, mesh)
    state, _, _ = frame(state, ds, bvh)
    np.testing.assert_array_equal(np.asarray(state.accum), single * 1.0)


def test_spp_sharded_matches_sequential(scene):
    """spp-parallel step (each chip renders one frame id, psum combine)
    must equal n sequential single-chip frames (same per-frame RNG
    streams; only the summation order differs)."""
    import numpy as np

    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.parallel import sharding

    n_dev = len(jax.devices())
    W = H = 32
    r = Renderer(scene, width=W, height=H, mode=RendererType.PATH, path_depth=2)
    r.render(n_dev)
    want = np.asarray(r.state.accum)

    mesh = sharding.make_mesh(n_dev)
    r2 = Renderer(scene, width=W, height=H, mode=RendererType.PATH, path_depth=2)
    frame = sharding.make_spp_sharded_frame_fn(mesh, RendererType.PATH, W, H, path_depth=2)
    state = sharding.shard_render_state(r2.state, mesh)
    # accum replicated for the spp axis (shard_render_state row-shards it)
    from optix_renderer_tpu.core.types import RenderState
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    state = RenderState(
        accum=_jax.device_put(r2.state.accum, rep),
        accum_id=_jax.device_put(r2.state.accum_id, rep),
        camera=_jax.tree_util.tree_map(lambda x: _jax.device_put(x, rep), r2.state.camera),
    )
    ds = sharding.replicate(r2.device_scene, mesh)
    bvh = sharding.replicate(r2.bvh, mesh)
    state, _, _ = frame(state, ds, bvh)
    got = np.asarray(state.accum)
    assert int(state.accum_id) == n_dev
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
