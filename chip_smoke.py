"""Smoke run of the renderer on the GPU: the quickest proof that it starts.

Phases, in order; each raises on failure:

  (a) device check: every JAX device must be a GPU (no CPU fallback);
  (b) the main path at full size, through ``Renderer`` and the CLI's
      ``main(argv)``: Cornell PATH 1024^2, Cornell LTC 512^2, cornell3
      RATIO 512^2 with ``--denoise-ratio``, gallery PATH 512^2 (textures,
      walk tier) and a ~1M-triangle terrain (NORMALS 1024^2, PATH 512^2);
  (c) each Pallas kernel against its plain jnp reference at real widths;
  (d) whole renders against the same renders on the CPU, made in a
      subprocess that never opens the card.

``--four-cards`` runs only (e): Cornell 1024^2 PATH tile-sharded and
spp-sharded over four GPUs against one-card renders of the same frames.

The last line of standard output is the JSON contract line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "scenes")

# the tolerances each comparison is held to
BRUTE_ID_MATCH = 0.9999   # share of lanes whose tri ids agree
BRUTE_T_RTOL = 1e-5       # |dt| / t on every hit lane; also the tie bound
LTC_RTOL, LTC_ATOL = 1e-4, 1e-6
POS_MAX_ABS = 1e-2        # g-buffer position, scene units (~550 wide)
IMG_REL_RMSE = 5e-3       # MC image on identical RNG streams
SHARD_REL_RMSE = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def contract_line(devices) -> str:
    """The JSON object the last line of the run must be."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def card_info() -> list[str]:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def rel_rmse(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()) / max(np.abs(b).mean(), 1e-12))


def _mem() -> str:
    import jax

    s = jax.devices()[0].memory_stats() or {}
    return (f"peak_bytes_in_use {s.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB, "
            f"bytes_in_use {s.get('bytes_in_use', 0) / 2**30:.3f} GiB")


def _frame_memory(r) -> str:
    """``memory_analysis()`` of the Renderer's single-frame function."""
    from optix_renderer_tpu.engine.renderer import _frame_jit

    ma = _frame_jit.lower(
        r.state, r.device_scene, r.bvh, mode=r.mode, width=r.width,
        height=r.height, path_depth=r.path_depth,
        ratio_samples=r.ratio_samples).compile().memory_analysis()
    if ma is None:
        return "frame memory_analysis: unavailable"
    return (f"frame memory_analysis: temp {ma.temp_size_in_bytes / 2**20:.1f} MiB, "
            f"args {ma.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {ma.output_size_in_bytes / 2**20:.1f} MiB")


def _check_image(name, img) -> None:
    import numpy as np

    img = np.asarray(img)
    if not np.isfinite(img).all() or float(img.max()) <= 0.0:
        raise RuntimeError(f"{name}: image not finite or all black")


# ---------------------------------------------------------------------------
# (b) main path
# ---------------------------------------------------------------------------

def _cli(label, argv, out_dir, result):
    """One render through the CLI, as a user runs it (cold: compile and
    set-up included); checks the image file it writes."""
    import numpy as np

    from optix_renderer_tpu.engine.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(argv + ["--out", out_dir, "--save-npy"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: cli rc={rc}")
    _check_image(label, np.load(os.path.join(out_dir, result)))
    with open(os.path.join(out_dir, "render.json")) as f:
        frames = json.load(f)["metrics"]["frames"]
    log(f"[b] {label} (cli, cold): wall {wall:.2f} s for {frames} frames, "
        f"compile and set-up included")


def _cell(label, scene_path, size, mode, frames, depth=4, bvh_cache=None):
    """The same render through ``Renderer``: a first pass (compiles unless
    the CLI already did), then a timed warm pass from a fresh
    accumulation."""
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.scene.config import parse_scene

    t0 = time.perf_counter()
    scene = parse_scene(scene_path)
    r = Renderer(scene, width=size, height=size, mode=mode, path_depth=depth,
                 bvh_cache_dir=bvh_cache)
    t_setup = time.perf_counter() - t0
    r.render(frames)
    t_first = time.perf_counter() - t0 - t_setup
    r.set_camera(scene.cameras[0])
    m0 = dict(r.metrics)
    r.render(frames)
    _check_image(label, r.image())
    m1 = r.metrics
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    log(f"[b] {label} ({r.device_scene.num_tris} tris): warm {secs:.4f} s for "
        f"{m1['frames'] - m0['frames']} frames ({secs / frames * 1e3:.2f} "
        f"ms/frame), {rays / secs / 1e6:.2f} Mrays/s honest; first pass "
        f"{t_first:.2f} s, set-up {t_setup:.2f} s; {_mem()}; {_frame_memory(r)}")


def phase_main_path(work: str, terrain_grid: int = 708, full: bool = True):
    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.scene import procedural

    big, res = (1024, 512) if full else (64, 32)
    spp = 16 if full else 2
    cornell = os.path.join(SCENES, "cornell", "scene.json")
    cornell3 = os.path.join(SCENES, "cornell3", "scene.json")
    gallery = os.path.join(SCENES, "gallery", "scene.json")
    bvh_cache = os.path.join(work, "bvh")

    label = f"cornell PATH {big}^2 depth 4 x {spp} spp"
    _cli(label, ["--scene", cornell, "--renderer", "path", "--spp", str(spp),
                 "--res", str(big), "--depth", "4"],
         os.path.join(work, "cornell_path"), "path.npy")
    _cell(label, cornell, big, RendererType.PATH, spp)

    _cell(f"cornell LTC_BASELINE {res}^2", cornell, res,
          RendererType.LTC_BASELINE, 1)

    label = f"cornell3 RATIO {res}^2 x {spp} spp + denoise"
    _cli(label, ["--scene", cornell3, "--renderer", "ratio", "--spp", str(spp),
                 "--res", str(res), "--denoise-ratio"],
         os.path.join(work, "cornell3_ratio"), "ratio_final.npy")
    _cell(label, cornell3, res, RendererType.RATIO, spp)

    _cell(f"gallery PATH {res}^2 depth 4 x {spp} spp", gallery, res,
          RendererType.PATH, spp)

    t0 = time.perf_counter()
    terrain = procedural.write_terrain_scene(
        os.path.join(work, "terrain"), grid=terrain_grid)
    log(f"[b] terrain scene (grid {terrain_grid}) written in "
        f"{time.perf_counter() - t0:.2f} s")
    label = f"terrain NORMALS {big}^2"
    _cli(label, ["--scene", terrain, "--renderer", "normals", "--res", str(big),
                 "--bvh-cache", bvh_cache],
         os.path.join(work, "terrain_normals"), "normals.npy")
    _cell(label, terrain, big, RendererType.NORMALS, 1, bvh_cache=bvh_cache)
    _cell(f"terrain PATH {res}^2 depth 4 x 1 frame", terrain, res,
          RendererType.PATH, 1, bvh_cache=bvh_cache)


# ---------------------------------------------------------------------------
# (c) kernels against the plain reference
# ---------------------------------------------------------------------------

def _ltc_inputs(R: int, L: int, seed: int):
    import jax.numpy as jnp
    import numpy as np

    from optix_renderer_tpu.core import math as cm
    from optix_renderer_tpu.shading import ltc

    rng = np.random.default_rng(seed)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    to_local, _ = cm.orthonormal_basis(jnp.asarray(n))
    wo_local = cm.normalize(cm.apply_mat(to_local, jnp.asarray(wo)), eps=1e-30)
    alpha = jnp.asarray(rng.uniform(0.01, 1, size=(R,)).astype(np.float32))
    ltc_mat, amp = ltc.fetch_ltc_mat(alpha, cm.spherical_theta(wo_local))
    mat_a = ltc._matmul33(ltc.iso_frame_from_wo_local(wo_local), to_local)
    mat_b = ltc._matmul33(cm.matrix_inverse_3x3(ltc_mat), mat_a)
    lv1 = rng.normal(size=(L, 3)).astype(np.float32) * 3 + np.float32([0, 4, 0])
    lv2 = lv1 + rng.normal(size=(L, 3)).astype(np.float32)
    lv3 = lv1 + rng.normal(size=(L, 3)).astype(np.float32)
    ln = np.cross(lv2 - lv1, lv3 - lv1)
    ln = (ln / np.linalg.norm(ln, axis=1, keepdims=True)).astype(np.float32)
    lemit = rng.uniform(0, 5, size=(L, 3)).astype(np.float32)
    p = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32) * 2.0)
    diffuse = jnp.asarray(rng.uniform(0, 1, size=(R, 3)).astype(np.float32))
    lights = tuple(jnp.asarray(a) for a in (lv1, lv2, lv3, ln, lemit))
    return p, diffuse, mat_a, mat_b, amp, lights


def _timed(f, *args, n=10):
    """Median seconds of ``n`` warm calls (the first call compiles)."""
    import jax
    import numpy as np

    out = jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def _soup(n_tris: int, seed: int = 3):
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.random((n_tris, 1, 3), np.float32) * 500.0
    return (base + (rng.random((n_tris, 3, 3), np.float32) - 0.5) * 40.0).astype(np.float32)


def _rays_through(lo, hi, n: int, seed: int):
    import jax.numpy as jnp
    import numpy as np

    from optix_renderer_tpu.core.types import Ray

    rng = np.random.default_rng(seed)
    o = lo + rng.random((n, 3), np.float32) * (hi - lo)
    d = lo + rng.random((n, 3), np.float32) * (hi - lo) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(origin=jnp.asarray(o), direction=jnp.asarray(d.astype(np.float32)))


def phase_kernels(n_rays: int = 1 << 20, ltc_rays: int = 512 * 512):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optix_renderer_tpu.accel import pallas_trace, traverse
    from optix_renderer_tpu.accel.build import build_bvh
    from optix_renderer_tpu.scene.config import parse_scene
    from optix_renderer_tpu.scene.device import build_device_scene
    from optix_renderer_tpu.shading import ltc

    # brute trace: Triton kernel vs the jnp tier, Cornell and a 4,096 soup
    ds = build_device_scene(parse_scene(os.path.join(SCENES, "cornell", "scene.json")))
    cornell = np.asarray(ds.vertices)[np.asarray(ds.tri_index)]
    for name, tris in (("cornell", cornell), ("soup", _soup(4096))):
        bvh = build_bvh(tris)
        lo, hi = tris.reshape(-1, 3).min(axis=0), tris.reshape(-1, 3).max(axis=0)
        rays = _rays_through(lo + 1.0, hi - 1.0, n_rays, seed=7)
        t_max = jnp.asarray(np.random.default_rng(9).uniform(
            1.0, float(np.linalg.norm(hi - lo)), n_rays).astype(np.float32))
        got, t_k = _timed(jax.jit(pallas_trace.trace_closest_kernel), bvh, rays)
        want, t_j = _timed(jax.jit(traverse.trace_closest_brute_jnp), bvh, rays)
        occ, ta_k = _timed(jax.jit(pallas_trace.trace_any_kernel), bvh, rays, 0.0, t_max)
        occ_ref, ta_j = _timed(jax.jit(traverse.trace_any_brute_jnp), bvh, rays, 0.0, t_max)
        log(f"[c] brute trace {name} ({len(tris)} tris, {n_rays} rays): closest "
            f"kernel {t_k * 1e3:.3f} ms vs jnp {t_j * 1e3:.3f} ms; any-hit kernel "
            f"{ta_k * 1e3:.3f} ms vs jnp {ta_j * 1e3:.3f} ms")
        compare_hits(got.t, got.tri_id, want.t, want.tri_id,
                     f"brute kernel vs jnp tier, {name}", tag="c")
        n_bad = int((np.asarray(occ) != np.asarray(occ_ref)).sum())
        log(f"[c] any-hit {name}: {n_bad} lanes differ (need 0)")
        if n_bad:
            raise RuntimeError(f"any-hit kernel disagrees with the jnp tier ({name})")

    # LTC: fused kernel vs the jnp pipeline
    kernel = jax.jit(ltc.polygon_sum_kernel)
    ref = jax.jit(ltc.polygon_sum_xla)
    for L in (1, 3, 7):
        args = jax.block_until_ready(_ltc_inputs(ltc_rays, L, seed=L))
        got, t_k = _timed(kernel, *args)
        with jax.default_matmul_precision("highest"):
            want, t_x = _timed(ref, *args)
        got, want = np.asarray(got), np.asarray(want)
        bad = np.abs(got - want) > LTC_ATOL + LTC_RTOL * np.abs(want)
        log(f"[c] ltc {ltc_rays} rays x {L} lights: kernel {t_k * 1e3:.3f} ms vs "
            f"jnp {t_x * 1e3:.3f} ms; max abs err {np.abs(got - want).max():.3e}, "
            f"lanes outside rtol {LTC_RTOL} atol {LTC_ATOL}: "
            f"{int(bad.any(axis=1).sum())} (need 0)")
        if not np.isfinite(got).all() or bad.any():
            raise RuntimeError(f"ltc kernel disagrees with the reference at L={L}")


# ---------------------------------------------------------------------------
# (d) consistency with the CPU
# ---------------------------------------------------------------------------

_CPU_RENDER = """
import sys, numpy as np
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer
from optix_renderer_tpu.scene.config import parse_scene
scene, size, depth, frames, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
r = Renderer(parse_scene(scene), width=size, height=size, mode=RendererType.PATH, path_depth=depth)
r.render(frames)
np.save(out + ".img.npy", r.image())
np.save(out + ".pos.npy", np.asarray(r.gbuffers.position))
"""

_CPU_BRUTE = """
import sys, numpy as np, jax.numpy as jnp
from optix_renderer_tpu.accel.traverse import intersect_brute
from optix_renderer_tpu.core.types import Ray
z = np.load(sys.argv[1])
hit = intersect_brute(jnp.asarray(z["tris"]), Ray(origin=jnp.asarray(z["o"]), direction=jnp.asarray(z["d"])))
np.savez(sys.argv[2], t=np.asarray(hit.t), tri=np.asarray(hit.tri_id))
"""


def run_on_cpu(code: str, *args: str) -> None:
    """Run ``code`` in a child process that sees no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the child's CUDA plugin logs that it found no device: keep its
    # output unless the child fails
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=HERE, env=env,
                         timeout=900, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"CPU subprocess failed (rc={out.returncode}):\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")


def compare_hits(t, tri, t_ref, tri_ref, label: str, tag: str = "d") -> None:
    """Hit-for-hit comparison with the tolerances at the top of the file."""
    import numpy as np

    t, tri, t_ref, tri_ref = map(np.asarray, (t, tri, t_ref, tri_ref))
    if ((tri >= 0) != (tri_ref >= 0)).any():
        raise RuntimeError(f"{label}: hit/miss classification differs")
    hit = tri_ref >= 0
    same = tri == tri_ref
    rel = np.abs(t - t_ref)[hit] / np.maximum(np.abs(t_ref[hit]), 1e-30)
    ties_ok = bool((rel[~same[hit]] <= BRUTE_T_RTOL).all())
    log(f"[{tag}] {label}: {int(hit.sum())} hits, tri id match {same.mean():.6f} "
        f"(need >= {BRUTE_ID_MATCH}), max rel t err {rel.max() if rel.size else 0:.3e} "
        f"(need <= {BRUTE_T_RTOL}), mismatches all ties: {ties_ok}")
    if same.mean() < BRUTE_ID_MATCH or not ties_ok or (rel.size and rel.max() > BRUTE_T_RTOL):
        raise RuntimeError(f"{label}: hits disagree with the oracle")


def _render_vs_cpu(label, scene, size, depth, frames, work):
    import numpy as np

    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.scene.config import parse_scene

    out = os.path.join(work, label.replace(" ", "_"))
    run_on_cpu(_CPU_RENDER, scene, str(size), str(depth), str(frames), out)
    r = Renderer(parse_scene(scene), width=size, height=size,
                 mode=RendererType.PATH, path_depth=depth)
    r.render(frames)
    img, pos = r.image(), np.asarray(r.gbuffers.position)
    img_c, pos_c = np.load(out + ".img.npy"), np.load(out + ".pos.npy")
    dpos = float(np.abs(pos - pos_c).max())
    rmse = rel_rmse(img, img_c)
    log(f"[d] {label} PATH {size}^2 depth {depth} x {frames} frames vs CPU: "
        f"position max abs err {dpos:.3e} (need < {POS_MAX_ABS}), image rel "
        f"RMSE {rmse:.3e} (need < {IMG_REL_RMSE})")
    if not (dpos < POS_MAX_ABS and rmse < IMG_REL_RMSE):
        raise RuntimeError(f"{label}: GPU render disagrees with the CPU render")


def phase_cpu_consistency(work: str, size: int = 128):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from optix_renderer_tpu.accel.traverse import BRUTE_MAX_TRIS, trace_closest
    from optix_renderer_tpu.core import rng as rnglib
    from optix_renderer_tpu.engine import camera as cameralib
    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.scene import procedural
    from optix_renderer_tpu.scene.config import parse_scene

    _render_vs_cpu("cornell", os.path.join(SCENES, "cornell", "scene.json"),
                   96, 3, 2, work)
    _render_vs_cpu("gallery", os.path.join(SCENES, "gallery", "scene.json"),
                   64, 3, 2, work)

    # ~10k-triangle terrain: primary hits of the walk vs the brute oracle
    scene = parse_scene(procedural.write_terrain_scene(
        os.path.join(work, "terrain72"), grid=72))
    r = Renderer(scene, width=size, height=size, mode=RendererType.NORMALS)
    T = r.device_scene.num_tris
    if T <= BRUTE_MAX_TRIS:
        raise RuntimeError("terrain check must run the walk tier")
    lin = jnp.arange(size * size, dtype=jnp.uint32)
    rs = rnglib.make_rng(10007, lin)
    rs, ju = rnglib.lcg_randomf(rs)
    rs, jv = rnglib.lcg_randomf(rs)
    rays = cameralib.primary_rays(r.state.camera, size, size, ju, jv, lin=lin)
    hit = jax.jit(trace_closest)(r.bvh, rays)
    tris = np.asarray(r.device_scene.vertices)[np.asarray(r.device_scene.tri_index)]
    src = os.path.join(work, "terrain_rays.npz")
    dst = os.path.join(work, "terrain_brute.npz")
    np.savez(src, tris=tris, o=np.asarray(rays.origin), d=np.asarray(rays.direction))
    run_on_cpu(_CPU_BRUTE, src, dst)
    ref = np.load(dst)
    compare_hits(hit.t, hit.tri_id, ref["t"], ref["tri"],
                 f"terrain {T} tris walk (GPU) vs brute oracle (CPU)")


# ---------------------------------------------------------------------------
# (e) four cards
# ---------------------------------------------------------------------------

def phase_four_cards(devices, size: int = 1024, depth: int = 4):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optix_renderer_tpu.engine.modes import RendererType
    from optix_renderer_tpu.engine.renderer import Renderer
    from optix_renderer_tpu.parallel import sharding
    from optix_renderer_tpu.scene.config import parse_scene

    n = len(devices)
    scene = parse_scene(os.path.join(SCENES, "cornell", "scene.json"))
    mode = RendererType.PATH
    mesh = sharding.make_mesh(n, devices=devices)
    r = Renderer(scene, width=size, height=size, mode=mode, path_depth=depth)
    host_state = jax.tree_util.tree_map(np.asarray, r.state)  # frame 0

    # one-card references: frame 0 alone, and frames 0..n-1 accumulated
    st = jax.tree_util.tree_map(jax.numpy.asarray, host_state)
    frames = []
    for _ in range(n):
        st, _, _ = r._frame(st, r.device_scene, r.bvh)
        frames.append(np.asarray(st.accum))
    one, seq = frames[0], frames[-1]

    ds = sharding.replicate(r.device_scene, mesh)
    bvh = sharding.replicate(r.bvh, mesh)
    rep = NamedSharding(mesh, P())
    tile = sharding.make_sharded_frame_fn(mesh, mode, size, size, path_depth=depth)
    spp = sharding.make_spp_sharded_frame_fn(mesh, mode, size, size, path_depth=depth)
    runs = {
        "tile": (tile, lambda: sharding.shard_render_state(host_state, mesh), one),
        "spp": (spp, lambda: jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), host_state), seq),
    }
    errs = {}
    for name, (fn, fresh, want) in runs.items():
        got = np.asarray(fn(fresh(), ds, bvh)[0].accum)  # compiles
        st0 = fresh()
        t0 = time.perf_counter()
        jax.block_until_ready(fn(st0, ds, bvh)[0].accum)
        dt = time.perf_counter() - t0
        errs[name] = rel_rmse(got, want)
        what = ("one frame, rows over the cards" if name == "tile"
                else f"{n} frames, one per card, psum")
        log(f"[e] cornell PATH {size}^2 depth {depth}, {name}-sharded over {n} "
            f"GPUs ({what}): rel RMSE vs one card {errs[name]:.3e} (need <= "
            f"{SHARD_REL_RMSE}), warm step {dt:.4f} s; {_mem()}")
    if max(errs.values()) > SHARD_REL_RMSE:
        raise RuntimeError("sharded renders disagree with one-card renders")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharding phase (e)")
    args = ap.parse_args(argv)

    import jax

    from optix_renderer_tpu.utils.device import enable_compile_cache, require_gpus

    enable_compile_cache()
    n_cards = 4 if args.four_cards else 1
    devices = require_gpus(n_cards)  # (a)
    if len(jax.devices()) != n_cards:
        raise RuntimeError(f"expected {n_cards} GPU(s), JAX sees {len(jax.devices())}")
    for line in card_info():
        log(line)  # name, power limit: as nvidia-smi prints them
    log(f"[a] jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            phase_four_cards(devices)
        else:
            for name, fn in (("b", lambda: phase_main_path(work)),
                             ("c", phase_kernels),
                             ("d", lambda: phase_cpu_consistency(work))):
                t0 = time.perf_counter()
                fn()
                log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s; {_mem()}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(contract_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
