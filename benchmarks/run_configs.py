"""Measure the staged configs on one GPU.

Writes benchmarks/RESULTS.json (RESULTS_smoke.json with ``--quick``) and
prints a markdown list.  Without a GPU it fails.

Timing convention (utils/timing.py): every per-frame figure is recorded
BOTH ways,
  * ``cold_ms``      — one dispatch, then ``block_until_ready`` (what an
                        interactive single frame pays), and
  * ``amortized_ms`` — N chained dispatches, one wait (what a frame
                        loop pays per frame).
Headline Mrays/s figures use the amortized time.  Multi-second configs
(2/3/6) time one warm ``Renderer.render(spp)`` call, which ends in
``block_until_ready``.

Usage: python benchmarks/run_configs.py [--quick]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from optix_renderer_tpu.engine.modes import RendererType  # noqa: E402
from optix_renderer_tpu.engine.renderer import Renderer  # noqa: E402
from optix_renderer_tpu.scene import procedural  # noqa: E402
from optix_renderer_tpu.scene.config import parse_scene  # noqa: E402
from optix_renderer_tpu.utils.device import enable_compile_cache, require_gpus  # noqa: E402
from optix_renderer_tpu.utils.timing import timeit  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
QUICK = "--quick" in sys.argv


def time_frame(r: Renderer, iters: int = 8):
    """cold/amortized seconds for ONE progressive frame of ``r``.

    Chains ``r._frame`` (donation rebinds the state each call) and waits
    on the accumulator (utils/timing.py).
    """
    box = {"s": r.state}

    def step():
        s, _gb, _aux = r._frame(box["s"], r.device_scene, r.bvh)
        box["s"] = s
        return s.accum

    res, _ = timeit(step, iters=iters)
    return res


def timed_render(scene, mode, spp, size, depth=4, **kw):
    """Warm `render(spp)` + time a second identical call (self-syncing)."""
    r = Renderer(scene, width=size, height=size, mode=mode, path_depth=depth, **kw)
    # warm the SAME call shape the timed window uses: render(spp)
    # compiles a multi-frame lax.scan that render(1) never touches
    r.render(spp)
    r.set_camera(r.scene.cameras[0])
    m0 = dict(r.metrics)
    t0 = time.perf_counter()
    r.render(spp)
    dt = time.perf_counter() - t0
    m1 = dict(r.metrics)
    rays = m1["rays_traced"] - m0["rays_traced"]
    m = {"mrays_per_sec": rays / dt / 1e6, "rays_traced": rays}
    return r, dt, spp, m


def rel_rmse(a, b):
    """Relative RMSE on Reinhard-tonemapped radiance.

    Raw-HDR squared error is dominated by MC fireflies (single-pixel
    outliers produce rel-RMSE >> 1 even between visually identical
    images); x/(1+x) bounds the range exactly like the display transform
    the reference's own goldens go through (save_images.py gamma)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / (1.0 + a)
    b = b / (1.0 + b)
    scale = max(float(np.abs(b).mean()), 1e-6)
    return float(np.sqrt(((a - b) ** 2).mean())) / scale


def cpu_reference(scene_path, size, mode, spp=1, depth=10):
    """Same frame rendered on the CPU backend (a subprocess that sees no
    GPU) — the backend-fidelity reference for RMSE rows.

    BASELINE's '<1% RMSE vs CUDA-reference images' is not directly
    measurable (the reference's scene assets are hardcoded paths on the
    author's machine, /root/reference/src/hostCode.cpp:14-15).  Two
    honest proxies are recorded instead: GPU-vs-CPU backend RMSE on
    identical RNG streams (catches kernel/lowering regressions —
    should be fp-reorder noise), and MC self-convergence RMSE vs an
    8x-spp run of the same estimator.  A cross-ESTIMATOR comparison
    (LTC vs converged MC direct) is deliberately NOT a quality row: the
    reference's own LTC mode omits the 1/pi Lambert and 0.5 lobe
    normalization its path BRDF uses (ltc_utils.cuh:126 'si.diffuse *
    lemit * D + amplitude * lemit * G' vs material.cuh:16-21), so the
    two modes photometrically disagree ~3.4x BY REFERENCE DESIGN.
    """
    import subprocess
    import sys as _sys

    out = os.path.join(tempfile.mkdtemp(), "ref.npy")
    code = f"""
import numpy as np
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer
from optix_renderer_tpu.scene.config import parse_scene
scene = parse_scene({scene_path!r})
r = Renderer(scene, width={size}, height={size}, mode=RendererType({int(mode)}),
             path_depth={depth})
r.render({spp})
np.save({out!r}, r.image())
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    subprocess.run([_sys.executable, "-c", code], check=True,
                   cwd=os.path.join(HERE, ".."), env=env)
    return np.load(out)


def main():
    enable_compile_cache()
    require_gpus(1)
    results = []
    dev = jax.devices()[0].device_kind
    cornell = parse_scene(os.path.join(HERE, "..", "scenes", "cornell", "scene.json"))
    cornell3 = parse_scene(os.path.join(HERE, "..", "scenes", "cornell3", "scene.json"))

    # config 1: Cornell 512^2 1spp LTC-direct (deterministic)
    size = 128 if QUICK else 512
    r = Renderer(cornell, width=size, height=size, mode=RendererType.LTC_BASELINE)
    res = time_frame(r)
    # quality: backend fidelity — the SAME deterministic frame on the
    # CPU backend (identical math; the LTC kernel on the GPU vs the jnp
    # path on the CPU); any drift beyond fp reorder noise is a regression
    r.set_camera(r.scene.cameras[0])  # time_frame DONATED r.state; rebuild
    r.render(1)  # LTC converges in 1 frame
    ltc_img = np.asarray(r.image())
    cpu_ref = cpu_reference(
        os.path.join(HERE, "..", "scenes", "cornell", "scene.json"),
        size, RendererType.LTC_BASELINE)
    results.append({
        "config": f"1: LTC analytic direct, Cornell {size}^2 (deterministic)",
        "cold_ms": round(res["cold_s"] * 1e3, 1),
        "amortized_ms": round(res["amortized_s"] * 1e3, 1),
        "mrays_per_sec": round(size * size / res["amortized_s"] / 1e6, 2),
        "rmse_gpu_vs_cpu": round(rel_rmse(ltc_img, cpu_ref), 6),
    })

    # config 2: Cornell 4-bounce GGX path tracing, 64 spp
    size = 128 if QUICK else 1024
    spp = 4 if QUICK else 64
    r, dt, frames, m = timed_render(cornell, RendererType.PATH, spp, size, depth=4)
    # quality: the spp-budget image vs the SAME estimator converged
    # (keep accumulating on the same renderer) — residual MC noise
    img_at_spp = np.asarray(r.image())
    r.render(spp * 7)  # -> 8x the spp total
    results.append({
        "config": f"2: PATH 4-bounce full MIS, Cornell {size}^2 x {spp}spp",
        "seconds": round(dt, 2),
        "spp_per_sec": round(frames / dt, 2),
        "mrays_per_sec": round(m.get("mrays_per_sec", 0.0), 1),
        "rmse_vs_8x_spp": round(rel_rmse(img_at_spp, np.asarray(r.image())), 4),
    })

    # config 3: multi-area-light ratio estimator
    size = 96 if QUICK else 512
    spp = 2 if QUICK else 16
    r, dt, frames, m = timed_render(cornell3, RendererType.RATIO, spp, size)
    results.append({
        "config": f"3: RATIO estimator, 3-light Cornell {size}^2 x {spp}spp (4 shadow samples/px)",
        "seconds": round(dt, 2),
        "spp_per_sec": round(frames / dt, 2),
        "mrays_per_sec": round(m.get("mrays_per_sec", 0.0), 1),
    })

    # config 4: g-buffer + denoise pipeline
    import jax.numpy as jnp

    from optix_renderer_tpu.postprocess.denoise import atrous_denoise, ratio_combine

    gb = r.gbuffers

    @jax.jit
    def pipeline(direct, no_vis, ltc, normal, position):
        d = atrous_denoise(direct, normal, position)
        nv = atrous_denoise(no_vis, normal, position)
        return ratio_combine(ltc, d, nv)

    args4 = (jnp.asarray(r.aux["sto_direct"]), jnp.asarray(r.aux["sto_no_vis"]),
             jnp.asarray(r.aux["ltc"]), gb.normal, gb.position)
    res, combined = timeit(pipeline, *args4, iters=8)
    # quality: self-convergence of the COMBINED output — the same
    # pipeline fed 7x more stochastic shadow samples (see cpu_reference's
    # docstring for why no cross-estimator MC row exists)
    r.render(spp * 7)
    args4b = (jnp.asarray(r.aux["sto_direct"]), jnp.asarray(r.aux["sto_no_vis"]),
              jnp.asarray(r.aux["ltc"]), gb.normal, gb.position)
    combined8 = pipeline(*args4b)
    results.append({
        "config": f"4: g-buffer guided denoise x2 + ratio combine, {size}^2",
        "cold_ms": round(res["cold_s"] * 1e3, 1),
        "amortized_ms": round(res["amortized_s"] * 1e3, 1),
        "rmse_vs_8x_samples": round(
            rel_rmse(np.asarray(combined), np.asarray(combined8)), 4),
    })

    # config 5: Sponza-class terrain (BVH-walk tier)
    grid = 60 if QUICK else 708
    d5 = os.path.join(tempfile.gettempdir(), f"bench_terrain_{grid}")
    if not os.path.exists(os.path.join(d5, "scene.json")):
        procedural.write_terrain_scene(d5, grid=grid)
    t0 = time.perf_counter()
    terrain = parse_scene(os.path.join(d5, "scene.json"))
    t_load = time.perf_counter() - t0
    size = 64 if QUICK else 1024
    t0 = time.perf_counter()
    r5 = Renderer(terrain, width=size, height=size, mode=RendererType.NORMALS)
    t_build = time.perf_counter() - t0
    res = time_frame(r5)
    results.append({
        "config": f"5: terrain {r5.device_scene.num_tris} tris, primary g-buffer {size}^2",
        "load_s": round(t_load, 1),
        "build_s": round(t_build, 1),
        "cold_ms": round(res["cold_s"] * 1e3, 1),
        "amortized_ms": round(res["amortized_s"] * 1e3, 1),
        "mrays_per_sec": round(size * size / res["amortized_s"] / 1e6, 2),
    })

    # config 5b: terrain PATH depth-4 — the big-scene INCOHERENT-ray gate
    # (bounce + NEE shadow traces); one warm frame, self-syncing render()
    r5p = Renderer(terrain, width=size, height=size, mode=RendererType.PATH,
                   path_depth=4)
    r5p.render(1)  # warm compile (frame cost is accum-id independent)
    m0 = dict(r5p.metrics)
    t0 = time.perf_counter()
    r5p.render(1)
    t_frame = time.perf_counter() - t0
    rays5b = dict(r5p.metrics)["rays_traced"] - m0["rays_traced"]
    results.append({
        "config": f"5b: terrain {r5p.device_scene.num_tris} tris, "
                  f"PATH depth-4 {size}^2 x 1spp",
        "frame_s": round(t_frame, 2),
        # honest throughput: rays actually traced (primary + live NEE
        # shadow + live bounce, renderer.py metrics) / frame time
        "mrays_per_sec": round(rays5b / t_frame / 1e6, 2),
    })

    # config 6: committed multi-texture gallery (Model.cpp:164-242 loader
    # workload) — texture-path perf, PATH + analytic LTC
    gallery = parse_scene(os.path.join(HERE, "..", "scenes", "gallery", "scene.json"))
    size = 96 if QUICK else 512
    spp = 2 if QUICK else 16
    r6, dt, frames, m = timed_render(gallery, RendererType.PATH, spp, size, depth=4)
    img6 = np.asarray(r6.image())
    r6.render(spp * 7)  # converge to 8x for the quality row
    row = {
        "config": f"6: gallery {r6.device_scene.num_tris} tris (4 textures, "
                  f"{len(gallery.model.meshes)} meshes), PATH {size}^2 x {spp}spp",
        "seconds": round(dt, 2),
        "spp_per_sec": round(frames / dt, 2),
        "mrays_per_sec": round(m.get("mrays_per_sec", 0.0), 1),
        "rmse_vs_8x_spp": round(rel_rmse(img6, np.asarray(r6.image())), 4),
    }
    r6l = Renderer(gallery, width=size, height=size, mode=RendererType.LTC_BASELINE)
    res = time_frame(r6l)
    row["ltc_cold_ms"] = round(res["cold_s"] * 1e3, 1)
    row["ltc_amortized_ms"] = round(res["amortized_s"] * 1e3, 1)
    results.append(row)

    out = {"device": dev, "results": results,
           "convention": "cold = 1 dispatch + block_until_ready; "
                         "amortized = 8 chained dispatches, one wait; multi-second rows "
                         "time one warm render(spp) call"}
    # --quick is a smoke mode: it never overwrites the full results
    name = "RESULTS_smoke.json" if QUICK else "RESULTS.json"
    path = os.path.join(HERE, name)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"\n## BASELINE configs on {dev}\n")
    for row in results:
        row = dict(row)
        cfg = row.pop("config")
        print(f"- **{cfg}** — " + ", ".join(f"{k}={v}" for k, v in row.items()))
    print(f"\nwritten to {path}")


if __name__ == "__main__":
    main()
