"""Headline benchmark: PATH-mode Cornell box at 1024x1024 on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device": {...}}
All progress/diagnostics go to stderr.  Without a GPU it fails; any
failure exits non-zero with no JSON line.

Ray accounting is honest and matches engine/renderer.py (Renderer.metrics):
the path integrator reports per-bounce counts shaped (depth, 3) =
[alive lanes, shadow rays traced, bounce rays traced]
(integrators/path.py), and a frame traces
  width*height primary rays + sum(columns 1:) actually-traced rays.
NEE shadow rays with provably-zero contribution and dead-lane bounce rays
are NOT traced and NOT counted.

Environment: ``BENCH_RES`` (default 1024), ``BENCH_FRAMES`` (16) and
``BENCH_DEPTH`` (4) size the Cornell run.  ``BENCH_SCENE=terrain`` instead
times primary-ray trace+shade on the ~1M-triangle terrain
(``BENCH_TERRAIN_GRID`` to resize, e.g. 224 for ~100k tris).
"""

import json
import os
import sys
import tempfile
import time

import jax

from optix_renderer_tpu.utils.device import enable_compile_cache, require_gpus

HERE = os.path.dirname(os.path.abspath(__file__))
_t0 = time.perf_counter()


def _log(msg):
    print(f"[bench +{time.perf_counter() - _t0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def _device():
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def bench_terrain():
    """Primary trace+shade Mrays/s on the terrain scene (walk tier)."""
    import jax.numpy as jnp

    from optix_renderer_tpu.core import rng as rnglib
    from optix_renderer_tpu.engine import camera as cameralib
    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.engine.shade import trace_closest_si
    from optix_renderer_tpu.scene.config import parse_scene
    from optix_renderer_tpu.scene.procedural import write_terrain_scene

    grid = int(os.environ.get("BENCH_TERRAIN_GRID", "708"))
    W = H = 1024
    with tempfile.TemporaryDirectory() as d:
        scene = parse_scene(write_terrain_scene(d, grid=grid))
        r = Renderer(scene, width=W, height=H, mode=RendererType.NORMALS)
    n = W * H
    lin = jnp.arange(n, dtype=jnp.uint32)
    lin = jnp.moveaxis(lin.reshape(H // 32, 32, W // 32, 32), 1, 2).reshape(n)
    rs = rnglib.make_rng(10007, lin)
    rs, ju = rnglib.lcg_randomf(rs)
    rs, jv = rnglib.lcg_randomf(rs)
    rays = cameralib.primary_rays(r.state.camera, W, H, ju, jv, lin=lin)
    # scene/BVH as jit ARGUMENTS, not closed over: closing over them would
    # bake hundreds of MB of tables into the program as constants
    f = jax.jit(lambda d, b, ry: trace_closest_si(d, b, ry))
    _log("terrain: compiling + warmup")
    jax.block_until_ready(f(r.device_scene, r.bvh, rays))
    _log("terrain: timing")
    iters = 8
    t0 = time.perf_counter()
    for _ in range(iters):
        si = f(r.device_scene, r.bvh, rays)
    jax.block_until_ready(si)
    dt = (time.perf_counter() - t0) / iters
    mrays = n / dt / 1e6
    return {
        "metric": f"primary trace+shade, {r.device_scene.num_tris}-tri terrain, "
                  f"Mrays/s on one {_device()['kind']}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
    }


def bench_cornell():
    """Timed multi-frame PATH render after a warm-up of the same call."""
    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.scene.config import parse_scene

    res = int(os.environ.get("BENCH_RES", "1024"))
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    depth = int(os.environ.get("BENCH_DEPTH", "4"))
    scene = parse_scene(os.path.join(HERE, "scenes", "cornell", "scene.json"))
    _log(f"cornell {res}x{res} depth={depth} frames={frames}: build renderer")
    r = Renderer(scene, width=res, height=res, mode=RendererType.PATH,
                 path_depth=depth)
    # warm-up compiles BOTH programs the timed call uses (the multi-frame
    # scan and the single tail frame); then restart accumulation
    _log("warmup render (compiles)")
    r.render(frames)
    r.set_camera(scene.cameras[0])
    m0 = dict(r.metrics)
    _log("timing")
    t0 = time.perf_counter()
    r.render(frames)  # ends in block_until_ready
    dt = time.perf_counter() - t0
    m1 = r.metrics
    mrays = (m1["rays_traced"] - m0["rays_traced"]) / dt / 1e6
    _log(f"done: {mrays:.1f} Mrays/s ({dt:.3f}s for {frames} frames)")
    return {
        "metric": f"PATH {depth}-bounce MIS Cornell {res}x{res}, Mrays/s on "
                  f"one {_device()['kind']}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
    }


def main():
    enable_compile_cache()
    require_gpus(1)
    _log(f"device: {_device()}")
    res = bench_terrain() if os.environ.get("BENCH_SCENE") == "terrain" else bench_cornell()
    res["device"] = _device()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
