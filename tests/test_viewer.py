"""Live viewer: HTTP surface + camera-motion accumulator reset.

The viewer replaces the reference's SDL window (Main.hs:146-152, 247-408);
these tests drive the full loop — render thread, PNG endpoint, status
overlay, and the move→reset contract — over a real localhost socket.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from haskell_path_tracer.app.viewer import serve
from haskell_path_tracer.models import world
from haskell_path_tracer.render.renderer import Renderer
from haskell_path_tracer.utils.config import RenderConfig


@pytest.fixture(scope="module")
def viewer():
    config = RenderConfig(width=32, height=24, bounces=3, algorithm="inline")
    renderer = Renderer(config)
    server, state, thread = serve(
        world.main_scene(), world.initial_camera(), renderer, port=0
    )
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    yield f"http://127.0.0.1:{server.server_port}", state
    state.stop = True
    server.shutdown()


def _get(url, timeout=30):
    return urllib.request.urlopen(url, timeout=timeout)


def _wait_for_frame(base, state, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with state.lock:
            if state.png:
                return
        time.sleep(0.2)
    raise TimeoutError("no frame rendered")


def test_viewer_serves_page_and_png(viewer):
    base, state = viewer
    _wait_for_frame(base, state)
    page = _get(base + "/").read()
    assert b"<title>path tracer</title>" in page
    png = _get(base + "/image.png").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    status = json.loads(_get(base + "/status").read())
    assert status["iterations"] >= 1
    assert status["rays_per_s"] > 0


def test_viewer_move_resets_accumulation(viewer):
    base, state = viewer
    _wait_for_frame(base, state)
    # Accumulate enough that post-reset regrowth back to this level takes
    # a while (tiny frames render in milliseconds).
    deadline = time.time() + 120
    while time.time() < deadline:
        before_it = json.loads(_get(base + "/status").read())["iterations"]
        if before_it >= 50:
            break
        time.sleep(0.2)
    assert before_it >= 50
    before_pos = np.asarray(state.camera.position).copy()
    req = urllib.request.Request(
        base + "/move?fwd=1&right=0&up=0&dx=5&dy=0&sprint=1", method="POST"
    )
    assert _get(req).status == 200
    after_pos = np.asarray(state.camera.position)
    assert not np.allclose(before_pos, after_pos)
    # Accumulation restarted: published iteration count drops below where
    # it was, and the viewer keeps producing frames.
    deadline = time.time() + 60
    seen_reset = False
    while time.time() < deadline:
        it = json.loads(_get(base + "/status").read())["iterations"]
        if it < before_it:
            seen_reset = True
            break
        time.sleep(0.05)
    assert seen_reset


def test_viewer_404(viewer):
    base, state = viewer
    try:
        _get(base + "/nope")
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404
