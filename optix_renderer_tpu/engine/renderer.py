"""Progressive renderer: per-mode jitted frame functions + accumulation.

The reference's megakernel raygen switch (cuda_src/deviceCode.cu:59-175)
becomes one jitted frame function per mode family, sharing the
trace/shade stages.  Accumulation semantics are identical: each frame adds
its color into ``accum`` and the display image divides by the frame count
(deviceCode.cu:158-174).  The state pytree is donated so accumulation is
in-place on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.build import BVH, build_bvh_cached
from ..core import rng as rnglib
from ..core.types import Camera, GBuffers, RenderState
from ..scene.config import Scene, SceneCamera
from ..scene.device import DeviceScene, build_device_scene
from . import camera as cameralib
from .modes import DETERMINISTIC_MODES, GBUFFER_MODES, RendererType

def _block_dim(x: int) -> int:
    """Largest pixel-block edge (<= 32) dividing x."""
    for b in (32, 16, 8, 4, 2):
        if x % b == 0:
            return b
    return 1


def render_tile(
    camera,
    accum_id,
    ds: DeviceScene,
    bvh: BVH,
    row_offset,
    *,
    mode: RendererType,
    width: int,
    height: int,
    rows: int,
    path_depth: int,
    ratio_samples: int,
):
    """Render a horizontal tile of ``rows`` image rows starting at
    ``row_offset`` (traced scalar) of the full width x height frame.

    This is the unit of both single-chip rendering (one tile = the whole
    frame) and cross-chip image-tile data parallelism
    (parallel.sharding): pixel ids, and therefore RNG streams
    (deviceCode.cu:65-66), are *absolute*, so a sharded render is
    bit-identical to the single-chip one.

    Returns (color (rows*width, 3), gbuffers (rows, ...), aux dict).
    """
    from .shade import trace_closest_si

    n = rows * width
    # Square pixel-block ray order: neighbouring lanes get neighbouring
    # pixels in both axes, so lanes that run together walk similar BVH
    # nodes.  Blocking is a pure reshape/transpose permutation (no
    # gathers); RNG streams stay keyed by ABSOLUTE pixel id, so the image
    # is bit-identical to row-major rendering.
    bh = _block_dim(rows)
    bw = _block_dim(width)

    def block(a):  # pixel-major (n,) -> block-major
        a4 = a.reshape(rows // bh, bh, width // bw, bw)
        return jnp.moveaxis(a4, 1, 2).reshape(n)

    def unblock(a):  # block-major (n, ...) -> pixel-major
        rest = a.shape[1:]
        a4 = a.reshape((rows // bh, width // bw, bh, bw) + tuple(rest))
        return jnp.moveaxis(a4, 2, 1).reshape((n,) + tuple(rest))

    lin = (jnp.arange(n, dtype=jnp.uint32)
           + jnp.asarray(row_offset, jnp.uint32) * jnp.uint32(width))
    lin = block(lin)
    # get_rng(accumId + 10007, pixel, dims) — deviceCode.cu:65-66
    rstate = rnglib.make_rng(accum_id + 10007, lin)
    rstate, ju = rnglib.lcg_randomf(rstate)
    rstate, jv = rnglib.lcg_randomf(rstate)
    rays = cameralib.primary_rays(camera, width, height, ju, jv, lin=lin)
    si = trace_closest_si(ds, bvh, rays)

    aux: dict[str, jnp.ndarray] = {}
    if mode in GBUFFER_MODES:
        from ..integrators.gbuffer import gbuffer_color

        color = gbuffer_color(mode, si, ds.miss_color)
    elif mode == RendererType.LTC_BASELINE:
        from ..integrators.ltc_direct import ltc_baseline_color

        color = ltc_baseline_color(ds, rays, si)
    elif mode == RendererType.PATH:
        from ..integrators.path import path_color

        color, rstate, alive_counts = path_color(
            ds, bvh, rays, si, rstate, max_depth=path_depth
        )
        aux = {"path_alive_counts": alive_counts}
    elif mode == RendererType.RATIO:
        from ..integrators.ratio import ratio_color

        color, rstate, raux = ratio_color(
            ds, bvh, rays, si, rstate, n_samples=ratio_samples
        )
        aux = {k: unblock(v).reshape(rows, width, -1) for k, v in raux.items()}
    else:
        raise NotImplementedError(f"mode {mode}")

    color = unblock(color)
    gb = GBuffers(
        position=unblock(si.p).reshape(rows, width, 3),
        normal=unblock(si.n_geom).reshape(rows, width, 3),
        albedo=unblock(si.diffuse).reshape(rows, width, 3),
        alpha=unblock(si.alpha).reshape(rows, width),
        uv=unblock(si.uv).reshape(rows, width, 2),
        material_id=unblock(si.material_id.astype(jnp.float32)).reshape(rows, width),
    )
    return color, gb, aux


def _frame_impl(
    state: RenderState,
    ds: DeviceScene,
    bvh: BVH,
    *,
    mode: RendererType,
    width: int,
    height: int,
    path_depth: int,
    ratio_samples: int,
):
    """One single-device frame: the whole image is one tile.

    ``frame(state, ds, bvh) -> (state', gbuffers, aux)`` where ``aux`` is
    a dict of extra per-mode buffers (ratio estimator outputs,
    deviceCode.cu:117-144).  mode/shape parameters are jit-static.
    """
    color, gb, aux = render_tile(
        state.camera,
        state.accum_id,
        ds,
        bvh,
        0,
        mode=mode,
        width=width,
        height=height,
        rows=height,
        path_depth=path_depth,
        ratio_samples=ratio_samples,
    )
    accum = state.accum + color.reshape(height, width, 3)
    new_state = RenderState(accum=accum, accum_id=state.accum_id + 1, camera=state.camera)
    return new_state, gb, aux


def _frames_scan_impl(
    state: RenderState,
    ds: DeviceScene,
    bvh: BVH,
    *,
    n: int,
    mode: RendererType,
    width: int,
    height: int,
    path_depth: int,
    ratio_samples: int,
):
    """n accumulation frames inside ONE jit via lax.scan.

    One dispatch for the whole batch keeps the host out of the
    progressive loop.  The scan body drops the g-buffer outputs (XLA dead-code
    eliminates their computation); callers run one ordinary frame after
    the scan when they need gbuffers/aux.  RNG streams are keyed by the
    carried accum_id, so the result is bit-identical to n separate
    frames.

    RATIO carries its stochastic aux buffers (ltc / sto_direct /
    sto_no_vis) as on-device accumulators so every frame's shadow
    samples reach the ratio-combine pipeline (deviceCode.cu:117-144
    accumulates all buffers, not just the color).  Returns (state,
    sto_acc dict — SUMS over the n frames —, stacked small aux)."""
    ratio_keys = {"ltc": 3, "sto_direct": 1, "sto_no_vis": 1}

    def step(carry, _):
        st, sto = carry
        color, _gb, aux = render_tile(
            st.camera, st.accum_id, ds, bvh, 0,
            mode=mode, width=width, height=height, rows=height,
            path_depth=path_depth, ratio_samples=ratio_samples,
        )
        accum = st.accum + color.reshape(height, width, 3)
        if mode == RendererType.RATIO:
            sto = {k: sto[k] + aux[k] for k in sto}
        small = {k: v for k, v in aux.items() if k == "path_alive_counts"}
        return (RenderState(accum=accum, accum_id=st.accum_id + 1,
                            camera=st.camera), sto), small

    sto0 = ({k: jnp.zeros((height, width, c), jnp.float32)
             for k, c in ratio_keys.items()}
            if mode == RendererType.RATIO else {})
    (state, sto), small = jax.lax.scan(step, (state, sto0), None, length=n)
    return state, sto, small


_frames_scan_jit = jax.jit(
    _frames_scan_impl,
    static_argnames=("n", "mode", "width", "height", "path_depth", "ratio_samples"),
    keep_unused=True,
    donate_argnums=(0,),
)


# A single pjit object for ALL configurations, with the mode/shape
# parameters as jit-static kwargs.  Using one jit object matters: multiple
# jax.jit wrappers around closures/partials sharing the same __code__
# mis-dispatch on the C++ fastpath (the second renderer's steady-state
# call picks up the first one's executable and fails with a buffer-count
# mismatch).  One pjit object keys its cache on the static args correctly.
_frame_jit = jax.jit(
    _frame_impl,
    static_argnames=("mode", "width", "height", "path_depth", "ratio_samples"),
    # keep_unused: jaxlib 0.9's pjit fastpath caches the pruned-argument
    # list across static-arg configs; with pruning enabled the second
    # steady-state call of a new config supplies the previous config's
    # argument subset ("Execution supplied 35 buffers but compiled program
    # expected 41"). Disabling pruning makes every config's calling
    # convention identical.
    keep_unused=True,
    donate_argnums=(0,),
)


def _jitted_frame_fn(mode: RendererType, width: int, height: int, path_depth: int, ratio_samples: int):
    return functools.partial(
        _frame_jit,
        mode=mode,
        width=width,
        height=height,
        path_depth=path_depth,
        ratio_samples=ratio_samples,
    )


class Renderer:
    """Owns device arrays and the render loop (include/viewer.hpp's role,
    without the GLFW/ImGui shell — interactive view is postprocess/io's
    PNG path or an external viewer)."""

    def __init__(
        self,
        scene: Scene,
        width: int | None = None,
        height: int | None = None,
        mode: RendererType = RendererType.PATH,
        miss_color=(0.0, 0.0, 0.0),
        path_depth: int = 10,
        ratio_samples: int = 4,
        leaf_size: int = 4,
        bvh_cache_dir: str | None = None,
    ):
        self.scene = scene
        self.width = int(width or scene.img_width)
        self.height = int(height or scene.img_height)
        self.mode = RendererType(mode)
        self.path_depth = path_depth
        self.ratio_samples = ratio_samples

        # host mirror: the BVH builder consumes numpy, so it never reads
        # the just-uploaded geometry back from the device
        self.device_scene, host = build_device_scene(
            scene, miss_color=miss_color, return_host=True
        )
        tri_verts = host["vertices"][host["tri_index"]]
        self.bvh = build_bvh_cached(bvh_cache_dir, tri_verts, leaf_size=leaf_size)

        self._frame = _jitted_frame_fn(
            self.mode, self.width, self.height, path_depth, ratio_samples
        )
        self.state: RenderState = None  # set by set_camera
        self.gbuffers: GBuffers | None = None
        self.aux: dict[str, jnp.ndarray] = {}
        # per-session observability (SURVEY §5 metrics row): honest ray
        # accounting — primary rays + the integrator's secondary rays.
        # Device-side counts drain lazily on .metrics access, so the
        # render loop never waits on a device-to-host copy.
        self._metrics: dict = {"frames": 0, "rays_traced": 0, "seconds": 0.0,
                               "alive_per_bounce": []}
        self._pending_counts: list = []
        self.set_camera(scene.cameras[0])

    def set_mode(self, mode: RendererType) -> None:
        """Switch renderer mode at runtime (the viewer's ImGui combo,
        viewer.hpp:668-676) and restart accumulation; the per-mode jitted
        frame functions are cached by the shared pjit object, so switching
        back to a seen mode costs no recompile."""
        mode = RendererType(mode)
        if mode == self.mode:
            return
        self.mode = mode
        self._frame = _jitted_frame_fn(
            mode, self.width, self.height, self.path_depth, self.ratio_samples
        )
        self.state = RenderState(
            accum=jnp.zeros((self.height, self.width, 3), jnp.float32),
            accum_id=jnp.asarray(0, jnp.int32),
            camera=self.state.camera,
        )

    # -- camera ----------------------------------------------------------
    def set_camera(self, cam: SceneCamera) -> None:
        """Reset accumulation and rebuild the basis (viewer.hpp:621-657)."""
        device_cam = cameralib.camera_from_lookat(
            cam.from_, cam.at, cam.up, cam.cos_fovy, self.width, self.height
        )
        self.state = RenderState(
            accum=jnp.zeros((self.height, self.width, 3), jnp.float32),
            accum_id=jnp.asarray(0, jnp.int32),
            camera=device_cam,
        )

    # -- render loop ------------------------------------------------------
    def render(self, n_frames: int = 1) -> None:
        """Advance progressive accumulation by n_frames launches."""
        import time

        t0 = time.perf_counter()
        frames = 0
        # Multi-frame batches run inside one jit (lax.scan) for PATH,
        # RATIO and g-buffer modes: one dispatch per batch instead of one
        # per frame.  The last frame always goes through the ordinary
        # path so gbuffers/aux stay populated.
        scan_ok = (
            self.mode in GBUFFER_MODES
            or self.mode in (RendererType.PATH, RendererType.RATIO)
        ) and self.mode not in DETERMINISTIC_MODES
        n_scan = n_frames - 1 if scan_ok else 0
        ratio_acc = None
        if n_scan > 0:
            self.state, ratio_acc, saux = _frames_scan_jit(
                self.state, self.device_scene, self.bvh,
                n=n_scan, mode=self.mode, width=self.width,
                height=self.height, path_depth=self.path_depth,
                ratio_samples=self.ratio_samples,
            )
            frames += n_scan
            if "path_alive_counts" in saux:
                for i in range(n_scan):  # (n, depth) stacked by the scan
                    self._pending_counts.append(saux["path_alive_counts"][i])
        for _ in range(n_frames - n_scan):
            if self.mode in DETERMINISTIC_MODES and int(self.state.accum_id) >= 1:
                break  # analytic modes converge in one frame (SURVEY §2.9 #12)
            self.state, self.gbuffers, self.aux = self._frame(
                self.state, self.device_scene, self.bvh
            )
            frames += 1
            if self.mode == RendererType.PATH and "path_alive_counts" in self.aux:
                self._pending_counts.append(self.aux["path_alive_counts"])
        if ratio_acc and self.mode == RendererType.RATIO and frames:
            # merge the scan's accumulated stochastic buffers with the
            # final ordinary frame's: aux becomes the MEAN over all
            # frames of this call, so the ratio-combine/denoise pipeline
            # sees every frame's shadow samples (n_samples * frames per
            # pixel), matching the reference's accumulation of all
            # buffers (deviceCode.cu:117-144)
            self.aux = dict(self.aux)
            for k, acc in ratio_acc.items():
                self.aux[k] = (acc + self.aux[k]) / frames
        jax.block_until_ready(self.state.accum)
        self._metrics["seconds"] += time.perf_counter() - t0

        n = self.width * self.height
        rays = frames * n  # primary
        if self.mode == RendererType.RATIO:
            rays += self.ratio_samples * n * frames  # shadow visibility rays
        self._metrics["frames"] += frames
        self._metrics["rays_traced"] += rays

    # -- detached stepping (live viewer) ----------------------------------
    def render_step_detached(self):
        """One progressive frame computed from the CURRENT state WITHOUT
        mutating the renderer: returns (state, gbuffers, aux).  The live
        viewer renders outside its lock and either commits the result
        via :meth:`commit_step` or discards it when a camera/mode change
        raced the frame (viewer.hpp:553-568's async launch analog)."""
        return self._frame(self.state, self.device_scene, self.bvh)

    def commit_step(self, state, gbuffers, aux, seconds: float) -> None:
        """Adopt a detached frame + do the same metrics accounting as
        :meth:`render` (one non-scan frame)."""
        self.state = state
        self.gbuffers = gbuffers
        self.aux = aux
        if self.mode == RendererType.PATH and "path_alive_counts" in aux:
            self._pending_counts.append(aux["path_alive_counts"])
        self._metrics["seconds"] += seconds
        n = self.width * self.height
        rays = n
        if self.mode == RendererType.RATIO:
            rays += self.ratio_samples * n
        self._metrics["frames"] += 1
        self._metrics["rays_traced"] += rays

    @property
    def metrics(self) -> dict:
        """Observability dict; drains device-side per-bounce counts on
        access (keeps sync transfers out of the render loop)."""
        if self._pending_counts:
            # (frames, depth, 3): [alive lanes, shadow rays traced, bounce
            # rays traced] per bounce (integrators.path.path_color)
            alive = np.stack([np.asarray(c, np.int64) for c in self._pending_counts])
            self._pending_counts = []
            self._metrics["alive_per_bounce"] = [int(a) for a in alive[-1][:, 0]]
            # honest: only the NEE visibility + BSDF bounce rays the
            # tiers actually traced (zero-contribution lanes are culled)
            self._metrics["rays_traced"] += int(alive[:, :, 1:].sum())
        secs = self._metrics["seconds"]
        self._metrics["mrays_per_sec"] = (
            self._metrics["rays_traced"] / secs / 1e6 if secs else 0.0
        )
        return self._metrics

    def image(self) -> np.ndarray:
        """Displayed image: accum / frame count (deviceCode.cu:172)."""
        count = max(int(self.state.accum_id), 1)
        return np.asarray(self.state.accum) / count

    # -- checkpoint / resume (SURVEY §5) -----------------------------------
    def save_checkpoint(self, path: str) -> None:
        np.savez(
            path,
            accum=np.asarray(self.state.accum),
            accum_id=int(self.state.accum_id),
            cam_pos=np.asarray(self.state.camera.pos),
            cam_dir_00=np.asarray(self.state.camera.dir_00),
            cam_dir_du=np.asarray(self.state.camera.dir_du),
            cam_dir_dv=np.asarray(self.state.camera.dir_dv),
        )

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path)
        self.state = RenderState(
            accum=jnp.asarray(z["accum"]),
            accum_id=jnp.asarray(int(z["accum_id"]), jnp.int32),
            camera=Camera(
                pos=jnp.asarray(z["cam_pos"]),
                dir_00=jnp.asarray(z["cam_dir_00"]),
                dir_du=jnp.asarray(z["cam_dir_du"]),
                dir_dv=jnp.asarray(z["cam_dir_dv"]),
            ),
        )
