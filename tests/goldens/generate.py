"""Regenerate the framework's golden renders (run on the CPU backend).

The reference ships de-facto goldens (g_buffers/{vis,data}/*.png) but they
are 1920x1061 interactive-viewer screenshots of a scene whose assets are
not in the repo (hostCode.cpp:14 points at the author's machine), so exact
reconstruction is impossible.  Instead the framework commits its own
deterministic goldens of the same mode set on the procedural Cornell box
and tracks regressions against them (SURVEY §4 items 1/5).

Usage: python tests/goldens/generate.py
"""

import os
import sys

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402

from optix_renderer_tpu.engine.modes import RendererType  # noqa: E402
from optix_renderer_tpu.engine.renderer import Renderer  # noqa: E402
from optix_renderer_tpu.scene.config import parse_scene  # noqa: E402
from optix_renderer_tpu.scene import procedural  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE = 64
# mirror of the reference's dumped mode set (g_buffers: mask, normal,
# position, diffuse, alpha, ltc_direct, direct, path)
MODES = {
    "mask": (RendererType.MASK, 1),
    "normal": (RendererType.NORMALS, 1),
    "position": (RendererType.POSITION, 1),
    "diffuse": (RendererType.DIFFUSE, 1),
    "alpha": (RendererType.ALPHA, 1),
    "ltc_direct": (RendererType.LTC_BASELINE, 1),
    "path": (RendererType.PATH, 4),  # deterministic RNG -> reproducible
}
# the committed multi-texture/multi-mesh gallery (scenes/gallery — the
# Model.cpp:164-242 loader workload: 4 textures, 34 meshes, 3 lights)
GALLERY_MODES = {
    "gallery_diffuse": (RendererType.DIFFUSE, 1),  # texture sampling path
    "gallery_ltc": (RendererType.LTC_BASELINE, 1),  # 3-light analytic
    "gallery_path": (RendererType.PATH, 2),
}
GALLERY_DIR = os.path.join(HERE, "..", "..", "scenes", "gallery")


def render_all(scene_dir: str, only=None):
    path = os.path.join(scene_dir, "scene.json")
    if not os.path.exists(path):
        path = procedural.write_cornell_scene(scene_dir, width=SIZE, height=SIZE)
    scene = parse_scene(path)
    out = {}
    for name, (mode, spp) in MODES.items():
        if only is not None and name not in only:
            continue
        r = Renderer(scene, width=SIZE, height=SIZE, mode=mode, path_depth=4)
        r.render(spp)
        out[name] = r.image().astype(np.float32)
    return out


def render_gallery(only=None):
    scene = parse_scene(os.path.join(GALLERY_DIR, "scene.json"))
    out = {}
    for name, (mode, spp) in GALLERY_MODES.items():
        if only is not None and name not in only:
            continue
        r = Renderer(scene, width=SIZE, height=SIZE, mode=mode, path_depth=4)
        r.render(spp)
        out[name] = r.image().astype(np.float32)
    return out


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")  # goldens are CPU renders
    imgs = render_all(tempfile.mkdtemp())
    imgs.update(render_gallery())
    for name, img in imgs.items():
        np.save(os.path.join(HERE, f"{name}.npy"), img)
        print(f"golden {name}: mean={img.mean():.5f}")
    print(f"wrote {len(imgs)} goldens to {HERE}")
