"""Lightweight live viewer: a localhost HTTP progressive-render monitor.

The reference shows its progressive render in an SDL/OpenGL window with
WASD + mouselook camera control and an iteration-count overlay
(the reference's app/Main.hs:146-152, 247-323, 326-408).  Accelerator hosts are
headless, so the window becomes a dependency-free local web page
(SURVEY.md §2.2 "optional lightweight local viewer"):

  * a background thread runs the progressive render loop — the
    reference's `computationLoop`, including its batching schedule;
  * the page polls `/image.png` (tonemapped latest accumulator) and
    `/status` (iterations, rays/s — the reference's text overlay);
  * WASD / arrow-drag camera input POSTs to `/move`; camera motion
    resets the accumulator and keeps the same compiled step — exactly the
    reference's `inputLoop` contract (Main.hs:305-321).

Stdlib http.server only; nothing leaves localhost.  Start with:

    python -m haskell_path_tracer.app.viewer --width 400 --height 300
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>path tracer</title><style>
body { background: #111; color: #ddd; font: 14px monospace; text-align: center; }
img  { image-rendering: pixelated; margin-top: 1em; outline: 1px solid #333; }
#bar { margin-top: .5em; }
</style></head><body>
<div id="bar">connecting…</div>
<img id="view" width="%(w)d" height="%(h)d">
<div>WASD/space/ctrl move · drag to look · shift sprint</div>
<script>
const img = document.getElementById('view'), bar = document.getElementById('bar');
let keys = {}, dragging = false, lx = 0, ly = 0, dx = 0, dy = 0;
onkeydown = e => keys[e.key.toLowerCase()] = true;
onkeyup   = e => keys[e.key.toLowerCase()] = false;
img.onmousedown = e => { dragging = true; lx = e.clientX; ly = e.clientY; e.preventDefault(); };
onmouseup   = () => dragging = false;
onmousemove = e => { if (dragging) { dx += e.clientX - lx; dy += e.clientY - ly; lx = e.clientX; ly = e.clientY; } };
function refresh() { img.src = '/image.png?t=' + Date.now(); }
img.onload = () => setTimeout(refresh, 100);
img.onerror = () => setTimeout(refresh, 500);
refresh();
setInterval(async () => {
  const t = (keys.w?1:0)-(keys.s?1:0), r = (keys.d?1:0)-(keys.a?1:0),
        u = (keys[' ']?1:0)-(keys.control?1:0);
  if (t || r || u || dx || dy) {
    await fetch('/move?fwd='+t+'&right='+r+'&up='+u+'&dx='+dx+'&dy='+dy+
                '&sprint='+(keys.shift?1:0), {method:'POST'});
    dx = dy = 0;
  }
  const s = await (await fetch('/status')).json();
  bar.textContent = s.iterations + ' spp · ' + (s.rays_per_s/1e6).toFixed(1) + ' Mrays/s';
}, 50);
</script></body></html>"""


class ViewerState:
    """The `MVar Result` analog (Main.hs:24-29): one lock, one snapshot."""

    def __init__(self, scene, camera, renderer, exposure, gamma):
        self.lock = threading.Lock()
        self.scene = scene
        self.camera = camera
        self.renderer = renderer
        self.exposure = exposure
        self.gamma = gamma
        self.acc = renderer.init_accumulator()
        self.png = b""
        self.iterations = 0
        self.rays_per_s = 0.0
        self.moved = False
        self.stop = False
        self.error = None

    def apply_move(self, fwd, right, up, dx, dy, sprint):
        import math

        from .interact import move_camera

        # Reject non-finite input (e.g. /move?fwd=nan) before it poisons
        # the camera and kills the render loop.
        vals = (fwd, right, up, dx, dy)
        if not all(math.isfinite(v) for v in vals):
            return
        with self.lock:
            self.camera = move_camera(
                self.camera,
                # camera-local axes: x right, y up, z backward (FORWARD=-z)
                [right, up, -fwd],
                [dy, dx, 0.0],
                elapsed=0.05,
                sprint=sprint,
            )
            self.moved = True


def render_loop(state: ViewerState):
    """`computationLoop` (Main.hs:198-242): step, publish, repeat; camera
    motion restarts accumulation with the same compiled function.  A crash
    is recorded in `state.error` (surfaced via /status) instead of
    silently killing the daemon thread."""
    try:
        _render_loop(state)
    except Exception as e:  # pragma: no cover - depends on runtime faults
        import traceback

        with state.lock:
            state.error = f"{type(e).__name__}: {e}"
        traceback.print_exc()


def _render_loop(state: ViewerState):
    from ..utils.image import encode_png, tonemap

    renderer = state.renderer
    done = 0
    while not state.stop:
        with state.lock:
            if state.moved:
                state.acc = renderer.init_accumulator()
                done = 0
                state.moved = False
            scene, camera, acc = state.scene, state.camera, state.acc
        n = min(renderer.batch_size(done), 32)
        t0 = time.perf_counter()
        acc = renderer.step(scene, camera, acc, spp=n)
        img = renderer.image(acc)  # blocks on device completion
        dt = time.perf_counter() - t0
        done += n
        # Row 0 carries the downward rays (reference array layout); files/
        # canvases put row 0 at top, so flip to display upright — the same
        # correction save_render applies (utils/image.py).
        png = encode_png(tonemap(img[::-1], state.exposure, state.gamma))
        cfg = renderer.config
        with state.lock:
            if state.moved:
                continue  # stale result; drop it (reference drops it too)
            state.acc = acc
            state.png = png
            state.iterations = done
            state.rays_per_s = cfg.width * cfg.height * cfg.bounces * n / dt


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                cfg = state.renderer.config
                page = _PAGE % {"w": cfg.width, "h": cfg.height}
                self._send(200, "text/html", page.encode())
            elif path == "/image.png":
                with state.lock:
                    png = state.png
                if not png:
                    self._send(503, "text/plain", b"rendering")
                else:
                    self._send(200, "image/png", png)
            elif path == "/status":
                with state.lock:
                    body = json.dumps(
                        {
                            "iterations": state.iterations,
                            "rays_per_s": round(state.rays_per_s),
                            "error": state.error,
                        }
                    ).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            u = urlparse(self.path)
            if u.path == "/move":
                q = parse_qs(u.query)

                def f(k):
                    return float(q.get(k, ["0"])[0])

                state.apply_move(
                    f("fwd"), f("right"), f("up"), f("dx"), f("dy"),
                    bool(int(q.get("sprint", ["0"])[0])),
                )
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(
    scene,
    camera,
    renderer,
    host: str = "127.0.0.1",
    port: int = 8265,
    exposure: float = 0.6,
    gamma: float = 2.2,
):
    """Start the render thread + HTTP server; blocks until Ctrl-C.
    Returns (server, state) when `port=0` picks an ephemeral port and the
    caller wants to drive it programmatically (tests)."""
    state = ViewerState(scene, camera, renderer, exposure, gamma)
    thread = threading.Thread(target=render_loop, args=(state,), daemon=True)
    thread.start()
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.state = state
    return server, state, thread


def main(argv=None) -> int:
    from ..models import world
    from ..models.io import load_scene
    from ..render.renderer import Renderer
    from ..utils.config import add_cli_args, config_from_args

    p = argparse.ArgumentParser(prog="haskell_path_tracer.viewer")
    add_cli_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--scene", default=None)
    p.add_argument("--exposure", type=float, default=0.6)
    p.add_argument("--gamma", type=float, default=2.2)
    args = p.parse_args(argv)
    from ..utils import compile_cache

    compile_cache.configure()

    config = config_from_args(args)
    if args.scene:
        scene, camera = load_scene(args.scene)
        if camera is None:
            camera = world.initial_camera()
    else:
        scene, camera = world.main_scene(), world.initial_camera()

    renderer = Renderer(config)
    server, state, _ = serve(
        scene, camera, renderer,
        host=args.host, port=args.port,
        exposure=args.exposure, gamma=args.gamma,
    )
    print(f"viewing at http://{args.host}:{server.server_port}/  (Ctrl-C stops)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop = True
        server.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
