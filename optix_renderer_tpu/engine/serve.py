"""Live interactive viewer: a local HTTP loop over the progressive renderer.

The reference's primary UX is a GLFW/ImGui window — FPS readout, runtime
renderer combo, mouse orbit camera, camera-record/screenshot keys
(include/viewer.hpp:65-148, 659-845).  A render node is headless, so the
equivalent here is a browser page served from the render process: the
render loop keeps accumulating on-device, the page polls PNG frames, and
camera/mode input round-trips as tiny JSON control messages (the
host<->device boundary stays one accumulation state).

Parity map (viewer.hpp):
* FPS / frame-time readout (:667)        -> /status JSON + page statusbar
* renderer combo (:668-676)              -> mode buttons / number keys
* mouse orbit + zoom (OWLViewer manips)  -> drag / wheel / arrow keys
* ``R`` record camera, ``F`` flush into the scene json (:808-839)
  -> ``R`` key: POST /control {"op": "record"} appends to cameras[] and
     (if a path was given) rewrites the scene JSON on disk
* ``P`` screenshot (:841-845)            -> ``P`` key: saves PNG server-side
* camera change restarts accumulation (:621-657) -> Renderer.set_camera
"""

from __future__ import annotations

import io
import json
import threading
import time

import jax
import numpy as np

from ..scene.config import SceneCamera
from ..utils.log import get_logger
from .modes import DETERMINISTIC_MODES, RENDERER_NAMES, RendererType

log = get_logger("serve")


_PAGE = """<!doctype html>
<html><head><title>optix_renderer_tpu</title><style>
body { background: #111; color: #ddd; font: 13px monospace; margin: 12px; }
#img { image-rendering: pixelated; border: 1px solid #333; cursor: grab; }
button { background: #222; color: #ddd; border: 1px solid #444; margin: 1px;
         font: 12px monospace; cursor: pointer; }
button.active { background: #375; }
#bar { margin: 6px 0; }
</style></head><body>
<div id="modes"></div>
<div id="bar">connecting…</div>
<img id="img" width="%W%" height="%H%">
<div>drag: orbit &nbsp; wheel: zoom &nbsp; shift+drag: pan &nbsp; arrows: orbit
&nbsp; 0-9: mode &nbsp; R: record cam &nbsp; P: screenshot &nbsp; space: reset</div>
<script>
const img = document.getElementById('img'), bar = document.getElementById('bar');
let busy = false;
async function ctl(body) {
  await fetch('/control', {method: 'POST', body: JSON.stringify(body)});
}
async function tick() {
  if (!busy) {
    busy = true;
    try {
      const s = await (await fetch('/status')).json();
      bar.textContent = `${s.mode_name}  spp=${s.accum_id}  ` +
        `${s.fps.toFixed(1)} fps  ${s.mrays.toFixed(1)} Mrays/s  ${s.width}x${s.height}`;
      document.querySelectorAll('#modes button').forEach(b =>
        b.classList.toggle('active', +b.dataset.m === s.mode));
      const r = await fetch('/frame.png?t=' + Date.now());
      const b = await r.blob();
      const url = URL.createObjectURL(b);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
    } catch (e) {}
    busy = false;
  }
  setTimeout(tick, 250);
}
fetch('/status').then(r => r.json()).then(s => {
  const div = document.getElementById('modes');
  s.mode_names.forEach((n, i) => {
    const b = document.createElement('button');
    b.textContent = i + ':' + n; b.dataset.m = i;
    b.onclick = () => ctl({op: 'mode', mode: i});
    div.appendChild(b);
  });
});
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY, e.shiftKey]; e.preventDefault(); };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY, drag[2]];
  ctl(drag[2] ? {op: 'pan', dx: dx, dy: dy} : {op: 'orbit', daz: -dx * 0.01, del: dy * 0.01});
};
img.onwheel = e => { ctl({op: 'zoom', f: e.deltaY > 0 ? 1.1 : 0.9}); e.preventDefault(); };
window.onkeydown = e => {
  if (e.key >= '0' && e.key <= '9') ctl({op: 'mode', mode: +e.key});
  else if (e.key === 'ArrowLeft') ctl({op: 'orbit', daz: 0.1, del: 0});
  else if (e.key === 'ArrowRight') ctl({op: 'orbit', daz: -0.1, del: 0});
  else if (e.key === 'ArrowUp') ctl({op: 'orbit', daz: 0, del: 0.1});
  else if (e.key === 'ArrowDown') ctl({op: 'orbit', daz: 0, del: -0.1});
  else if (e.key === ' ') ctl({op: 'reset'});
  else if (e.key === 'r' || e.key === 'R') ctl({op: 'record'});
  else if (e.key === 'p' || e.key === 'P') ctl({op: 'screenshot'});
};
tick();
</script></body></html>"""


def _png_bytes(img: np.ndarray) -> bytes:
    """Tonemap (pow 1/2.2, save_images.py:12-17) + vertical flip -> PNG."""
    from PIL import Image

    u8 = (np.clip(img[::-1], 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="PNG")
    return buf.getvalue()


class OrbitCamera:
    """Host-side look-at state with orbit/pan/zoom ops (the OWLViewer
    camera manipulator's role)."""

    def __init__(self, cam: SceneCamera):
        self.home = cam
        self.reset()

    def reset(self):
        self.from_ = np.asarray(self.home.from_, np.float64).copy()
        self.at = np.asarray(self.home.at, np.float64).copy()
        self.up = np.asarray(self.home.up, np.float64).copy()
        self.cos_fovy = float(self.home.cos_fovy)

    def as_scene_camera(self) -> SceneCamera:
        return SceneCamera(
            from_=self.from_.astype(np.float32),
            at=self.at.astype(np.float32),
            up=self.up.astype(np.float32),
            cos_fovy=self.cos_fovy,
        )

    def orbit(self, daz: float, dele: float):
        v = self.from_ - self.at
        r = np.linalg.norm(v)
        upn = self.up / np.linalg.norm(self.up)
        # azimuth about up
        c, s = np.cos(daz), np.sin(daz)
        v = v * c + np.cross(upn, v) * s + upn * np.dot(upn, v) * (1 - c)
        # elevation about the right axis, clamped off the poles
        right = np.cross(v, upn)
        rn = np.linalg.norm(right)
        if rn > 1e-9:
            right /= rn
            c, s = np.cos(dele), np.sin(dele)
            v2 = v * c + np.cross(right, v) * s + right * np.dot(right, v) * (1 - c)
            cosang = np.dot(v2 / np.linalg.norm(v2), upn)
            if abs(cosang) < 0.995:
                v = v2
        self.from_ = self.at + v / np.linalg.norm(v) * r

    def zoom(self, f: float):
        self.from_ = self.at + (self.from_ - self.at) * f

    def pan(self, dx: float, dy: float):
        v = self.at - self.from_
        d = np.linalg.norm(v)
        fwd = v / d
        right = np.cross(fwd, self.up)
        right /= np.linalg.norm(right)
        upv = np.cross(right, fwd)
        step = d * 0.002
        delta = (-dx * right + dy * upv) * step
        self.from_ += delta
        self.at += delta


class ViewerServer:
    """HTTP viewer over a Renderer.  ``serve_forever`` blocks; ``start``
    runs in background threads (tests drive it that way)."""

    def __init__(self, renderer, scene_path: str | None = None,
                 host: str = "127.0.0.1", port: int = 8000,
                 out_dir: str = ".", max_spp: int = 0):
        self.r = renderer
        self.scene_path = scene_path
        self.out_dir = out_dir
        self.max_spp = max_spp  # 0 = accumulate forever
        self.cam = OrbitCamera(renderer.scene.cameras[0])
        self.lock = threading.Lock()  # guards renderer state
        self.dirty = threading.Event()  # wakes the render loop
        self.stop = threading.Event()
        self.recorded: list[SceneCamera] = []
        self._fps = 0.0
        self._png: bytes = b""
        self._png_id = (-1, -1)
        self.epoch = 0  # bumped on every state-changing control op

        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = _PAGE.replace("%W%", str(outer.r.width)).replace(
                        "%H%", str(outer.r.height))
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame.png":
                    self._send(200, outer.frame_png(), "image/png")
                elif path == "/status":
                    self._send(200, json.dumps(outer.status()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n) or "{}")
                out = outer.control(msg)
                self._send(200, json.dumps(out).encode())

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # -- state ------------------------------------------------------------
    def status(self) -> dict:
        r = self.r
        return {
            "mode": int(r.mode),
            "mode_name": RENDERER_NAMES[int(r.mode)],
            "mode_names": RENDERER_NAMES,
            "accum_id": int(r.state.accum_id),
            "width": r.width,
            "height": r.height,
            "fps": self._fps,
            "mrays": float(r.metrics.get("mrays_per_sec", 0.0)),
            "epoch": self.epoch,
        }

    def frame_png(self) -> bytes:
        # snapshot refs under the lock, transfer + encode OUTSIDE it: the
        # D2H of the accum buffer and the PNG encode are the slow parts
        # and must not block /control while they run
        with self.lock:
            key = (self.epoch, int(self.r.state.accum_id))
            if key == self._png_id:
                return self._png
            accum = self.r.state.accum
        if key[1]:
            img = np.asarray(accum) / max(key[1], 1)
        else:
            img = np.zeros((self.r.height, self.r.width, 3), np.float32)
        png = _png_bytes(img)
        with self.lock:
            # last writer wins; cache only if still current
            if (self.epoch, int(self.r.state.accum_id)) == key:
                self._png = png
                self._png_id = key
        return png

    def control(self, msg: dict) -> dict:
        op = msg.get("op")
        with self.lock:
            if op == "orbit":
                self.cam.orbit(float(msg.get("daz", 0)), float(msg.get("del", 0)))
                self.r.set_camera(self.cam.as_scene_camera())
            elif op == "zoom":
                self.cam.zoom(float(msg.get("f", 1.0)))
                self.r.set_camera(self.cam.as_scene_camera())
            elif op == "pan":
                self.cam.pan(float(msg.get("dx", 0)), float(msg.get("dy", 0)))
                self.r.set_camera(self.cam.as_scene_camera())
            elif op == "reset":
                self.cam.reset()
                self.r.set_camera(self.cam.as_scene_camera())
            elif op == "mode":
                self.r.set_mode(RendererType(int(msg["mode"])))
            elif op == "record":
                cam = self.cam.as_scene_camera()
                self.recorded.append(cam)
                n = self._flush_cameras()
                log.info("recorded camera #%d%s", len(self.recorded),
                         f" -> {self.scene_path}" if n else "")
            elif op == "screenshot":
                import os

                path = os.path.join(
                    self.out_dir, f"screenshot_{int(time.time())}.png")
                with open(path, "wb") as f:
                    f.write(_png_bytes(self.r.image()))
                log.info("screenshot -> %s", path)
                self.dirty.set()
                return {"ok": True, "path": path}
            else:
                return {"ok": False, "error": f"unknown op {op!r}"}
            self.epoch += 1
        self.dirty.set()
        return {"ok": True, "epoch": self.epoch}

    def _flush_cameras(self) -> int:
        """viewer.hpp:826-839: append the just-recorded camera into the
        scene JSON's cameras[] (the ``R`` + ``F`` key pair, collapsed:
        every record flushes immediately)."""
        if not self.scene_path:
            return 0
        with open(self.scene_path) as f:
            doc = json.load(f)
        c = self.recorded[-1]
        doc.setdefault("cameras", []).append({
            "from": [float(x) for x in c.from_],
            "to": [float(x) for x in c.at],
            "up": [float(x) for x in c.up],
            "cos_fovy": float(c.cos_fovy),
        })
        with open(self.scene_path, "w") as f:
            json.dump(doc, f, indent=2)
        return 1

    # -- loops ------------------------------------------------------------
    def _render_loop(self):
        """Progressive accumulation with the frame computed OUTSIDE the
        lock: snapshot (epoch, state) -> device step -> sync -> swap
        under the lock only if no control op raced the frame (stale
        results are discarded — the next iteration renders from the new
        state).  /status, /control and /frame.png therefore respond in
        milliseconds even while a multi-second big-scene frame is in
        flight; the reference UI never blocks on a frame either
        (viewer.hpp:553-568 async launch + event loop)."""
        while not self.stop.is_set():
            with self.lock:
                epoch0 = self.epoch
                mode = self.r.mode
                accum_id = int(self.r.state.accum_id)
            done = (mode in DETERMINISTIC_MODES and accum_id >= 1) or (
                self.max_spp and accum_id >= self.max_spp)
            if not done:
                t0 = time.perf_counter()
                state, gb, aux = self.r.render_step_detached()
                jax.block_until_ready(state.accum)
                dt = time.perf_counter() - t0
                with self.lock:
                    if self.epoch == epoch0:
                        self.r.commit_step(state, gb, aux, dt)
                        self._fps = 0.8 * self._fps + 0.2 * (1.0 / max(dt, 1e-9))
                    # else: a camera/mode op landed mid-frame; discard
            else:
                self.dirty.wait(timeout=0.25)
                self.dirty.clear()

    def start(self):
        self._threads = [
            threading.Thread(target=self._render_loop, daemon=True),
            threading.Thread(target=self.httpd.serve_forever, daemon=True),
        ]
        for t in self._threads:
            t.start()
        log.info("live viewer at http://%s:%d/", *self.httpd.server_address[:2])

    def shutdown(self):
        self.stop.set()
        self.dirty.set()
        self.httpd.shutdown()

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.shutdown()
