"""Command-line renderer.

Replaces the reference's hardcoded app entry (src/hostCode.cpp:8-55 —
fixed scene path, fixed 1024x1024, fixed PATH renderer) with real flags
that honor the scene JSON (SURVEY §2.9 quirk 13 fixed).  Viewer-parity
features without the GLFW window (include/viewer.hpp):

* ``--preview N`` — progressive PNG refresh every N frames (the
  interactive accumulation display, viewer.hpp:553-568);
* ``--cam-from/--cam-to/--cam-up/--cam-fovy`` — camera manipulation;
* ``--record-camera`` — write the active camera back into the scene
  JSON's ``cameras`` list (the R/F key flow, viewer.hpp:802-845);
* ``--profile DIR`` — jax.profiler trace of the render loop;
* ``--devices N`` — image-row sharded rendering over a device mesh
  (parallel.sharding; bit-identical to one device).

Example:
  python -m optix_renderer_tpu.engine.cli --scene scenes/cornell/scene.json \\
      --renderer path --spp 64 --res 512 --out /tmp/render
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..scene.config import parse_scene
from ..utils.log import get_logger, log_ok
from .modes import DETERMINISTIC_MODES, RENDERER_NAMES, RendererType

log = get_logger()

_MODE_BY_NAME = {n.lower().replace(" ", "_"): RendererType(i) for i, n in enumerate(RENDERER_NAMES)}
_MODE_BY_NAME.update({m.name.lower(): m for m in RendererType})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="optix_renderer_tpu", description=__doc__)
    p.add_argument("--scene", required=True, help="scene JSON (reference schema)")
    p.add_argument(
        "--renderer",
        default=None,
        help=f"one of {sorted(set(_MODE_BY_NAME))} or an int mode id; default: scene's first renderer",
    )
    p.add_argument("--spp", type=int, default=None, help="samples per pixel (default: scene spp)")
    p.add_argument("--res", type=int, default=None, help="square resolution override")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--camera", type=int, default=0, help="camera index from the scene")
    p.add_argument("--cam-from", type=float, nargs=3, default=None, help="camera position override")
    p.add_argument("--cam-to", type=float, nargs=3, default=None, help="camera look-at override")
    p.add_argument("--cam-up", type=float, nargs=3, default=None, help="camera up override")
    p.add_argument("--cam-fovy", type=float, default=None, help="cos_fovy override")
    p.add_argument("--record-camera", action="store_true",
                   help="append the active camera to the scene JSON's cameras (viewer.hpp R/F keys)")
    p.add_argument("--depth", type=int, default=10, help="max path depth (PATH mode)")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--save-gbuffers", action="store_true", help="dump all g-buffers")
    p.add_argument("--save-npy", action="store_true", help="also dump lossless .npy")
    p.add_argument("--save-exr", action="store_true", help="also dump float32 EXR")
    p.add_argument("--checkpoint", default=None, help="resume accumulation from this .npz")
    p.add_argument("--save-checkpoint", default=None, help="write accumulation state here")
    p.add_argument("--denoise-ratio", action="store_true", help="RATIO mode: denoise + combine on device")
    p.add_argument("--preview", type=int, default=0, metavar="N",
                   help="write a progressive preview PNG every N frames")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render loop into DIR")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="shard the render over N devices (image rows; needs height %% N == 0)")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--bvh-cache", metavar="DIR", default=None,
                   help="bake/reuse the acceleration structure in DIR "
                        "(content-addressed; stale-proof)")
    p.add_argument("--serve", type=int, nargs="?", const=8000, default=None,
                   metavar="PORT",
                   help="start the live HTTP viewer (orbit camera, runtime "
                        "mode switch; viewer.hpp:659-845 equivalent) instead "
                        "of a batch render")
    return p


def resolve_mode(arg: str | None, scene) -> RendererType:
    if arg is None:
        return RendererType(scene.renderers[0]) if scene.renderers else RendererType.PATH
    try:
        return RendererType(int(arg))
    except ValueError:
        key = arg.lower().replace("-", "_")
        if key not in _MODE_BY_NAME:
            raise SystemExit(f"unknown renderer {arg!r}; choose from {sorted(set(_MODE_BY_NAME))}")
        return _MODE_BY_NAME[key]


def _record_camera(scene_path: str, cam) -> None:
    """Append the camera to the scene JSON (viewer.hpp:802-845: R records
    into Viewer::cameras, F rewrites the JSON's 'cameras' array)."""
    with open(scene_path, "r") as f:
        cfg = json.load(f)
    cfg.setdefault("cameras", []).append(
        {
            "from": [float(x) for x in cam.from_],
            "to": [float(x) for x in cam.at],
            "up": [float(x) for x in cam.up],
            "cos_fovy": float(cam.cos_fovy),
        }
    )
    with open(scene_path, "w") as f:
        json.dump(cfg, f, indent=2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from ..utils.device import enable_compile_cache

    enable_compile_cache()
    from ..postprocess.io import save_exr, save_npy, save_png
    from ..scene.config import SceneCamera
    from .renderer import Renderer

    scene = parse_scene(args.scene)
    mode = resolve_mode(args.renderer, scene)
    width = args.width or args.res or scene.img_width
    height = args.height or args.res or scene.img_height
    spp = args.spp if args.spp is not None else scene.spp
    if mode in DETERMINISTIC_MODES:
        spp = 1

    log.info(
        "scene=%s mode=%s %dx%d spp=%d depth=%d device=%s",
        args.scene, mode.name, width, height, spp, args.depth,
        jax.devices()[0].device_kind,
    )

    r = Renderer(scene, width=width, height=height, mode=mode,
                 path_depth=args.depth, bvh_cache_dir=args.bvh_cache)
    cam = scene.cameras[args.camera if args.camera < len(scene.cameras) else 0]
    if any(v is not None for v in (args.cam_from, args.cam_to, args.cam_up, args.cam_fovy)):
        cam = SceneCamera(
            from_=np.asarray(args.cam_from if args.cam_from is not None else cam.from_, np.float32),
            at=np.asarray(args.cam_to if args.cam_to is not None else cam.at, np.float32),
            up=np.asarray(args.cam_up if args.cam_up is not None else cam.up, np.float32),
            cos_fovy=float(args.cam_fovy if args.cam_fovy is not None else cam.cos_fovy),
        )
    r.set_camera(cam)
    if args.checkpoint:
        r.load_checkpoint(args.checkpoint)
        log.info("resumed at accum_id=%d", int(r.state.accum_id))

    os.makedirs(args.out, exist_ok=True)
    name = mode.name.lower()

    if args.serve is not None:
        from .serve import ViewerServer

        server = ViewerServer(
            r, scene_path=args.scene, port=args.serve, out_dir=args.out,
            max_spp=args.spp or 0,
        )
        log.info("live viewer: http://127.0.0.1:%d/  (ctrl-C to stop)", server.port)
        server.serve_forever()
        return 0

    def render_loop():
        if args.devices > 1:
            from ..parallel import sharding

            mesh = sharding.make_mesh(args.devices)
            frame = sharding.make_sharded_frame_fn(
                mesh, mode, width, height, path_depth=args.depth,
                ratio_samples=r.ratio_samples,
            )
            state = sharding.shard_render_state(r.state, mesh)
            ds = sharding.replicate(r.device_scene, mesh)
            bvh = sharding.replicate(r.bvh, mesh)
            alive_frames = []
            t_loop = time.perf_counter()
            for _ in range(spp):
                state, r.gbuffers, r.aux = frame(state, ds, bvh)
                if "path_alive_counts" in r.aux:
                    alive_frames.append(r.aux["path_alive_counts"])
            jax.block_until_ready(state.accum)  # waits for every shard
            r.metrics["seconds"] += time.perf_counter() - t_loop
            r.state = state  # image()/checkpoints gather lazily
            # honest ray accounting, matching Renderer.render/metrics:
            # primary + RATIO shadow samples + the NEE/bounce rays the
            # tiers actually traced, aggregated across the device shards
            n_px = width * height
            rays = spp * n_px
            if mode == RendererType.RATIO:
                rays += spp * n_px * r.ratio_samples
            if alive_frames:
                # each frame's counts: (n_devices * depth, 3) shard-stacked
                # [alive, shadow rays traced, bounce rays traced] rows
                alive = np.stack(
                    [np.asarray(a, np.int64).reshape(args.devices, -1, 3).sum(axis=0)
                     for a in alive_frames]
                )
                rays += int(alive[:, :, 1:].sum())
                r.metrics["alive_per_bounce"] = [int(a) for a in alive[-1][:, 0]]
            r.metrics["frames"] += spp
            r.metrics["rays_traced"] += rays
            log.info("sharded over %d devices (%s)", args.devices, mesh.devices.ravel()[0].platform)
            return
        if args.preview and args.preview < spp:
            done = 0
            while done < spp:
                step = min(args.preview, spp - done)
                r.render(step)
                done = int(r.state.accum_id)
                save_png(os.path.join(args.out, f"{name}_preview.png"), r.image())
                log.info("preview %d/%d spp", done, spp)
        else:
            r.render(spp)

    t0 = time.perf_counter()
    if args.profile:
        with jax.profiler.trace(args.profile):
            render_loop()
        log.info("profiler trace -> %s", args.profile)
    else:
        render_loop()
    img = r.image()
    dt = time.perf_counter() - t0
    m = r.metrics
    log_ok(log, "rendered %d frame(s) in %.2fs (%.1f Mrays/s honest, %.2f spp/s)"
           % (m["frames"], dt, m.get("mrays_per_sec", 0.0), m["frames"] / max(dt, 1e-9)))

    save_png(os.path.join(args.out, f"{name}.png"), img)
    if args.save_npy:
        save_npy(os.path.join(args.out, f"{name}.npy"), img)
    if args.save_exr:
        save_exr(os.path.join(args.out, f"{name}.exr"), img)

    if args.save_gbuffers and r.gbuffers is not None:
        gb = r.gbuffers
        for field, arr in [
            ("position", gb.position),
            ("normal", np.asarray(gb.normal) * 0.5 + 0.5),
            ("albedo", gb.albedo),
            ("alpha", gb.alpha),
            ("material_id", gb.material_id),
        ]:
            save_png(os.path.join(args.out, f"gbuffer_{field}.png"), np.asarray(arr), apply_gamma=False)
            if args.save_npy:
                save_npy(os.path.join(args.out, f"gbuffer_{field}.npy"), np.asarray(arr))
            if args.save_exr:
                save_exr(os.path.join(args.out, f"gbuffer_{field}.exr"), np.asarray(arr))

    if mode == RendererType.RATIO and r.aux:
        import jax.numpy as jnp

        from ..postprocess.denoise import atrous_denoise, ratio_combine

        for k, v in r.aux.items():
            if k.startswith("sto") or k == "ltc":
                save_png(os.path.join(args.out, f"{k}.png"), np.asarray(v))
        if args.denoise_ratio:
            gb = r.gbuffers
            d = atrous_denoise(jnp.asarray(r.aux["sto_direct"]), gb.normal, gb.position)
            n = atrous_denoise(jnp.asarray(r.aux["sto_no_vis"]), gb.normal, gb.position)
            final = np.asarray(ratio_combine(jnp.asarray(r.aux["ltc"]), d, n))
            save_png(os.path.join(args.out, "ratio_final.png"), final)
            if args.save_npy:
                save_npy(os.path.join(args.out, "ratio_final.npy"), final)

    if args.save_checkpoint:
        r.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint -> %s", args.save_checkpoint)

    if args.record_camera:
        _record_camera(args.scene, cam)
        log.info("camera recorded into %s", args.scene)

    manifest = {
        "scene": os.path.abspath(args.scene),
        "mode": mode.name,
        "width": width,
        "height": height,
        "spp": int(r.state.accum_id),
        "seconds": dt,
        "device": jax.devices()[0].device_kind,
        "metrics": {
            "frames": m["frames"],
            "rays_traced": m["rays_traced"],
            "mrays_per_sec": round(m.get("mrays_per_sec", 0.0), 2),
            "alive_per_bounce": m.get("alive_per_bounce", []),
        },
    }
    with open(os.path.join(args.out, "render.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    log.info("outputs -> %s/", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
