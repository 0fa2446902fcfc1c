"""Application-layer tests: scene IO, checkpoint/resume, camera
interaction, image writing, metrics, and the CLI end-to-end.

The reference has no tests at this layer (SURVEY.md §4 gaps); these cover
the subsystems the framework adds on top of the render core:
serialization round trips, atomic checkpointing, and the reference's
input-loop arithmetic (/root/reference/app/Main.hs:247-323)."""

import json
import os
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest

from haskell_path_tracer.models import world
from haskell_path_tracer.models.io import (
    load_scene,
    save_scene,
    scene_from_dict,
    scene_to_dict,
)
from haskell_path_tracer.models.objects import Accumulator, Camera
from haskell_path_tracer.utils.checkpoint import (
    load_accumulator,
    load_training_state,
    save_accumulator,
    save_training_state,
)
from haskell_path_tracer.utils.image import save_render, tonemap, write_png
from haskell_path_tracer.utils import metrics as M


# --- scene serialization ---------------------------------------------------


def test_scene_roundtrip(tmp_path):
    scene, cam = world.main_scene(), world.initial_camera()
    path = str(tmp_path / "scene.json")
    save_scene(path, scene, cam)
    scene2, cam2 = load_scene(path)

    np.testing.assert_array_equal(scene.spheres.pos, scene2.spheres.pos)
    np.testing.assert_array_equal(scene.spheres.radius, scene2.spheres.radius)
    np.testing.assert_array_equal(scene.planes.normal, scene2.planes.normal)
    for f in ["color", "illuminance", "brdf_kind", "brdf_param"]:
        np.testing.assert_array_equal(
            getattr(scene.spheres.material, f),
            getattr(scene2.spheres.material, f),
        )
        np.testing.assert_array_equal(
            getattr(scene.planes.material, f),
            getattr(scene2.planes.material, f),
        )
    np.testing.assert_array_equal(cam.position, cam2.position)
    np.testing.assert_array_equal(cam.rotation, cam2.rotation)
    np.testing.assert_array_equal(cam.fov, cam2.fov)


def test_scene_dict_omits_camera_when_absent():
    d = scene_to_dict(world.main_scene())
    assert "camera" not in d
    scene, cam = scene_from_dict(d)
    assert cam is None
    assert scene.spheres.count == world.main_scene().spheres.count


def test_scene_json_is_stable(tmp_path):
    """Serialize -> load -> serialize is a fixed point."""
    scene, cam = world.main_scene(), world.initial_camera()
    d1 = scene_to_dict(scene, cam)
    d2 = scene_to_dict(*scene_from_dict(json.loads(json.dumps(d1))))
    assert d1 == d2


# --- checkpointing ---------------------------------------------------------


def _acc(h=4, w=6, it=7):
    return Accumulator(
        color=jnp.arange(h * w * 3, dtype=jnp.float32).reshape(h, w, 3),
        rng=jnp.arange(h * w * 4, dtype=jnp.uint32).reshape(h, w, 4),
        iterations=jnp.asarray(it, jnp.int32),
    )


def test_checkpoint_roundtrip(tmp_path):
    acc = _acc()
    path = str(tmp_path / "ckpt.npz")
    save_accumulator(path, acc, extra={"loss": np.float32(0.5)})
    acc2, extra = load_accumulator(path)
    np.testing.assert_array_equal(acc.color, acc2.color)
    np.testing.assert_array_equal(acc.rng, acc2.rng)
    assert int(acc2.iterations) == 7
    assert float(extra["loss"]) == 0.5


def test_checkpoint_overwrite_is_atomic(tmp_path):
    """Overwriting an existing checkpoint never leaves a torn file."""
    path = str(tmp_path / "ckpt.npz")
    save_accumulator(path, _acc(it=1))
    save_accumulator(path, _acc(it=2))
    acc, _ = load_accumulator(path)
    assert int(acc.iterations) == 2
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_training_state_roundtrip(tmp_path):
    from haskell_path_tracer.diff import grad as G

    params = G.scene_to_params(world.main_scene())
    opt_state = {"m": jnp.zeros(3), "v": jnp.ones(3)}
    path = str(tmp_path / "train.npz")
    save_training_state(path, params, opt_state, step=42)
    p2, o2, step = load_training_state(path, params, opt_state)
    assert step == 42
    for a, b in zip(
        [params.sphere_pos, params.plane_color],
        [p2.sphere_pos, p2.plane_color],
    ):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(opt_state["v"], o2["v"])


# --- camera interaction ----------------------------------------------------


def test_move_camera_roll_clamp():
    from haskell_path_tracer.app.interact import ROLL_LIMIT, move_camera

    cam = world.initial_camera()
    # Huge upward mouse drag: dy of +1e6 px * -0.001 would swing roll far
    # past vertical; it must clamp at pi/2 - 0.001 (Main.hs:255-259).
    out = move_camera(cam, [0, 0, 0], [1e6, 0.0, 0.0])
    assert abs(float(out.rotation[0]) + ROLL_LIMIT) < 1e-6  # negative limit
    out = move_camera(cam, [0, 0, 0], [-1e6, 0.0, 0.0])
    assert abs(float(out.rotation[0]) - ROLL_LIMIT) < 1e-6


def test_move_camera_forward_is_rotated(rng):
    from haskell_path_tracer.app.interact import MOVEMENT_SPEED, move_camera

    # With zero rotation, "W" (local -z) moves along world -z by
    # speed * elapsed * 0.25 (Main.hs:264-266: walk factor 0.25).
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    out = move_camera(cam, [0, 0, -1], [0, 0, 0], elapsed=0.5)
    np.testing.assert_allclose(
        np.asarray(out.position),
        [0.0, 0.0, -MOVEMENT_SPEED * 0.5 * 0.25],
        atol=1e-6,
    )
    # Sprint quadruples it (shift factor 1 vs 0.25).
    out_s = move_camera(cam, [0, 0, -1], [0, 0, 0], elapsed=0.5, sprint=True)
    np.testing.assert_allclose(
        np.asarray(out_s.position), np.asarray(out.position) * 4.0, atol=1e-6
    )
    # Yaw 90deg: local -z maps to world -x (left-handed Euler convention of
    # anglesToQuaternion, Util.hs:55-67).
    cam_y = Camera.create([0.0, 0.0, 0.0], [0.0, np.pi / 2, 0.0], 90.0)
    out_y = move_camera(cam_y, [0, 0, -1], [0, 0, 0], elapsed=0.5)
    d = np.asarray(out_y.position)
    assert abs(d[1]) < 1e-6 and abs(d[2]) < 1e-5
    assert abs(abs(d[0]) - MOVEMENT_SPEED * 0.5 * 0.25) < 1e-5


def test_move_camera_normalizes_diagonal():
    from haskell_path_tracer.app.interact import move_camera

    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    straight = move_camera(cam, [0, 0, -1], [0, 0, 0])
    diagonal = move_camera(cam, [1, 0, -1], [0, 0, 0])
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(straight.position)),
        np.linalg.norm(np.asarray(diagonal.position)),
        rtol=1e-6,
    )


def test_move_camera_rotation_applied_before_translation():
    """The reference rotates first, then translates in the NEW frame
    (Main.hs:313-317: rotation' updated before `translate`)."""
    from haskell_path_tracer.app.interact import move_camera

    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    # Mouse dx that yaws by pi/2, while stepping "forward".
    out = move_camera(cam, [0, 0, -1], [0.0, -np.pi / 2 * 1000, 0.0])
    d = np.asarray(out.position)
    # Movement happened along the rotated frame (world +-x), not -z.
    assert abs(d[0]) > 1e-3 and abs(d[2]) < 1e-4


# --- image writing ---------------------------------------------------------


def test_tonemap_range_and_monotonicity():
    img = np.array([[[0.0, 0.5, 100.0]]], np.float32)
    out = tonemap(img)
    assert out.dtype == np.uint8
    assert out[0, 0, 0] == 0
    assert out[0, 0, 0] < out[0, 0, 1] < out[0, 0, 2]


def test_png_writer_valid(tmp_path):
    rgb = (np.arange(5 * 7 * 3) % 256).astype(np.uint8).reshape(5, 7, 3)
    path = str(tmp_path / "x.png")
    write_png(path, rgb)
    blob = open(path, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    # Parse IHDR, decompress IDAT, strip filter bytes, compare pixels.
    w, h = struct.unpack(">II", blob[16:24])
    assert (w, h) == (7, 5)
    idat_start = blob.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", blob[idat_start - 8 : idat_start - 4])[0]
    raw = zlib.decompress(blob[idat_start : idat_start + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), rgb)


def test_save_render_ppm(tmp_path):
    img = np.full((3, 4, 3), 0.18, np.float32)
    path = save_render(str(tmp_path / "x.ppm"), img, exposure=1.0, gamma=1.0)
    blob = open(path, "rb").read()
    assert blob.startswith(b"P6\n4 3\n255\n")
    px = np.frombuffer(blob.split(b"255\n", 1)[1], np.uint8)
    # 0.18 / 1.18 * 255 + 0.5 = 39.4
    assert (px == 39).all()


# --- metrics ---------------------------------------------------------------


def test_metrics_phases_and_rates():
    m = M.RenderMetrics(width=10, height=10, bounces=4)
    with m.phase("render"):
        pass
    with m.phase("render"):
        pass
    m.samples = 8
    m.wall_seconds = 2.0
    assert m.ray_segments == 10 * 10 * 8 * 4
    assert m.rays_per_second == m.ray_segments / 2.0
    d = json.loads(m.to_json())
    assert d["resolution"] == "10x10"
    assert "render" in d["phases"]


def test_structured_log(capsys):
    import sys

    M.log("bench", stream=sys.stdout, rays=123)
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["event"] == "bench" and rec["rays"] == 123


# --- CLI end-to-end --------------------------------------------------------


def test_cli_render_and_resume(tmp_path):
    from haskell_path_tracer.app.main import main

    out = str(tmp_path / "r.png")
    ckpt = str(tmp_path / "r.npz")
    argv = [
        "--width", "8", "--height", "8", "--bounces", "2", "--spp", "3",
        "--seed", "0", "--checkpoint", ckpt, "--quiet", "-o", out,
    ]
    assert main(argv) == 0
    assert os.path.exists(out)
    acc, _ = load_accumulator(ckpt)
    assert int(acc.iterations) == 3

    # Resume from the checkpoint and render 2 more samples.
    assert main(argv[:-7] + ["--spp", "5", "--checkpoint", ckpt,
                             "--resume", "--quiet", "-o", out]) == 0
    acc2, _ = load_accumulator(ckpt)
    assert int(acc2.iterations) == 5
    assert np.isfinite(np.asarray(acc2.color)).all()


def test_cli_save_scene(tmp_path):
    from haskell_path_tracer.app.main import main

    path = str(tmp_path / "scene.json")
    assert main(["--save-scene", path, "--quiet"]) == 0
    scene, cam = load_scene(path)
    assert scene.spheres.count == 5 and scene.planes.count == 2
    assert cam is not None


def test_cli_wavefront_variant(tmp_path):
    from haskell_path_tracer.app.main import main

    out = str(tmp_path / "w.ppm")
    assert main([
        "--width", "8", "--height", "6", "--bounces", "2", "--spp", "2",
        "--seed", "0", "--variant", "streams", "--quiet", "-o", out,
    ]) == 0
    assert os.path.exists(out)


def test_exr_roundtrip(tmp_path):
    from haskell_path_tracer.utils.image import read_exr, save_render, write_exr

    img = np.random.default_rng(5).uniform(0, 40, (9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "x.exr")
    write_exr(path, img)
    np.testing.assert_array_equal(read_exr(path), img)
    # save_render dispatches on suffix, skips the tonemap for HDR, and
    # flips vertically for display orientation (row 0 of the accumulator
    # carries the downward rays; see utils/image.py:save_render).
    save_render(str(tmp_path / "y.exr"), img, exposure=0.5)
    np.testing.assert_array_equal(
        read_exr(str(tmp_path / "y.exr")), img[::-1]
    )


# --- animation driver ------------------------------------------------------


def test_interpolate_path():
    from haskell_path_tracer.app.animate import interpolate_path

    kf = [
        {"position": [0, 0, 0], "rotation": [0, 0, 0], "fov": 90},
        {"position": [2, 0, 0], "rotation": [0, 1, 0], "fov": 60},
    ]
    frames = interpolate_path(kf, 5)
    assert len(frames) == 5
    np.testing.assert_allclose(frames[0][0], [0, 0, 0])
    np.testing.assert_allclose(frames[-1][0], [2, 0, 0])
    np.testing.assert_allclose(frames[2][0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(frames[2][1], [0, 0.5, 0], atol=1e-6)
    assert abs(frames[2][2] - 75.0) < 1e-4


def test_animate_renders_frames(tmp_path):
    from haskell_path_tracer.app.animate import main as animate_main

    from haskell_path_tracer.utils.image import read_exr

    pattern = str(tmp_path / "f_%02d.exr")
    assert animate_main([
        "--width", "32", "--height", "24", "--frames", "2", "--spp", "4",
        "--bounces", "4", "--orbit", "--quiet", "-o", pattern,
    ]) == 0
    a = read_exr(str(tmp_path / "f_00.exr"))
    b = read_exr(str(tmp_path / "f_01.exr"))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert a.max() > 0  # scene visible
    # Orbit cameras differ -> frames differ.
    assert not np.array_equal(a, b)


def test_cli_physical_threefry_sampler(tmp_path):
    """--variant physical --sampler threefry routes the stateless
    `jax.random` path end-to-end."""
    from haskell_path_tracer.app.main import main

    out = str(tmp_path / "t.png")
    argv = [
        "--width", "8", "--height", "8", "--bounces", "2", "--spp", "4",
        "--seed", "0", "--variant", "physical", "--sampler", "threefry",
        "--quiet", "-o", out,
    ]
    assert main(argv) == 0
    assert os.path.exists(out)


def test_threefry_batches_draw_fresh_streams():
    """Two successive stateless batches must not repeat samples (the key
    folds in the iteration count)."""
    import jax

    from haskell_path_tracer.models import world
    from haskell_path_tracer.render.integrator import make_accumulator
    from haskell_path_tracer.render.nee import (
        render_batch_physical_stateless,
    )

    scene, cam = world.main_scene(), world.initial_camera()
    acc = make_accumulator(16, 12, seed=3)
    step = jax.jit(
        lambda a: render_batch_physical_stateless(
            scene, cam, a, spp=2, num_bounces=3
        )
    )
    a1 = step(acc)
    a2 = step(a1)
    d1 = np.asarray(a1.color) - np.asarray(acc.color)
    d2 = np.asarray(a2.color) - np.asarray(a1.color)
    assert int(a2.iterations) == 4
    assert np.isfinite(d2).all()
    # Different streams -> different per-batch radiance.
    assert np.abs(d1 - d2).max() > 1e-6
    # SFC32 parity state untouched by the stateless sampler.
    np.testing.assert_array_equal(np.asarray(a2.rng), np.asarray(acc.rng))


def test_exr_zip_and_half_roundtrip(tmp_path):
    """ZIP-compressed and half-float EXR variants round-trip; compressed
    files are materially smaller on smooth images; files are also
    readable by OpenEXR-compatible third-party readers when available
    (imageio/OpenCV), guarding the interchange claim."""
    from haskell_path_tracer.utils.image import read_exr, write_exr

    rng = np.random.default_rng(3)
    # Half-quantized smooth field: representative interchange data (full-
    # random f32 mantissas are incompressible by design in any codec).
    base = (
        np.cumsum(rng.normal(size=(32, 48, 3)).astype(np.float32), 1)
        .astype(np.float16)
        .astype(np.float32)
    )

    p_none = str(tmp_path / "n.exr")
    p_zips = str(tmp_path / "s.exr")
    p_zip = str(tmp_path / "z.exr")
    p_half = str(tmp_path / "h.exr")
    write_exr(p_none, base, compression="none")
    write_exr(p_zips, base, compression="zips")
    write_exr(p_zip, base, compression="zip")
    write_exr(p_half, base, compression="zip", half=True)

    np.testing.assert_array_equal(read_exr(p_none), base)
    np.testing.assert_array_equal(read_exr(p_zips), base)
    np.testing.assert_array_equal(read_exr(p_zip), base)
    np.testing.assert_allclose(
        read_exr(p_half), base.astype(np.float16).astype(np.float32)
    )
    assert os.path.getsize(p_zip) < 0.8 * os.path.getsize(p_none)

    # Cross-check against an independent EXR implementation when one is
    # available (this image's OpenCV build ships without the EXR codec —
    # cv2.haveImageReader returns False — so the check self-skips here).
    os.environ["OPENCV_IO_ENABLE_OPENEXR"] = "1"
    try:
        import cv2

        if cv2.haveImageReader(p_none):
            for p, ref in [(p_zip, base), (p_none, base), (p_zips, base)]:
                got = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                assert got is not None, p
                np.testing.assert_allclose(
                    got[:, :, ::-1], ref, rtol=1e-6
                )
    except ImportError:
        pass


def test_threefry_replay():
    """Stateless semantics: a batch replays bit-exactly from (seed,
    iteration) alone, and another seed draws another stream."""
    from haskell_path_tracer.models import world
    from haskell_path_tracer.render.integrator import make_accumulator
    from haskell_path_tracer.render.nee import (
        render_batch_physical_stateless,
    )

    scene, cam = world.main_scene(), world.initial_camera()

    def batch(acc):
        return render_batch_physical_stateless(
            scene, cam, acc, spp=2, num_bounces=3
        )

    a = batch(make_accumulator(16, 16, seed=3))
    b = batch(make_accumulator(16, 16, seed=3))
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))
    c = batch(make_accumulator(16, 16, seed=4))
    assert np.abs(np.asarray(a.color) - np.asarray(c.color)).max() > 1e-6
