"""Parity megakernel (Triton route) vs the XLA inline integrator, with the
kernel in Pallas' interpret mode on the CPU.

On the GPU the kernel is validated statistically (transcendental ulps can
flip rare discrete decisions; the `chip`-marked tests and chip_smoke.py);
in interpret mode the same jnp ops run through the XLA CPU backend, so
agreement is near-exact.
"""

import numpy as np
import pytest

import nee_scenes
from haskell_path_tracer.models import world
from haskell_path_tracer.models.camera import primary_rays
from haskell_path_tracer.models.objects import Camera
from haskell_path_tracer.ops import pallas_megakernel as PM
from haskell_path_tracer.ops.pallas_megakernel import trace_inline_pallas
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_batch_inline,
    render_batch_pallas,
)

W, H = 128, 16
FRONT = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)


def _compare(spp, bounces, rr=False, min_close=0.995):
    scene, cam = world.main_scene(), world.initial_camera()
    ref = render_batch_inline(
        scene, cam, make_accumulator(W, H, seed=2), spp,
        num_bounces=bounces, russian_roulette=rr,
    )
    out = render_batch_pallas(
        scene, cam, make_accumulator(W, H, seed=2), spp,
        num_bounces=bounces, russian_roulette=rr,
        interpret=True,
    )
    assert int(out.iterations) == int(ref.iterations) == spp
    rng_match = (np.asarray(ref.rng) == np.asarray(out.rng)).all(axis=-1).mean()
    assert rng_match > 0.995, rng_match
    close = np.isclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-4, atol=1e-4
    ).mean()
    assert close > min_close, close


def test_pallas_matches_xla_single_sample():
    _compare(spp=1, bounces=4)


def test_pallas_matches_xla_multi_sample_deep():
    # Deep bounces amplify ulp-flipped discrete decisions (one flipped
    # bounce diverges that lane's color for all remaining sample-bounces),
    # so lane agreement sits lower than the shallow cases.
    _compare(spp=3, bounces=8, min_close=0.99)


def test_pallas_matches_xla_russian_roulette():
    _compare(spp=2, bounces=6, rr=True)


def test_pallas_tile_shapes(monkeypatch):
    """Results do not depend on the lane blocking: every block size and
    warp count gives bit-identical radiance and RNG, tail included."""
    scene, cam = world.main_scene(), world.initial_camera()
    w, h = 100, 3  # 300 pixels: a partial last block at every size
    rays = primary_rays(cam, w, h)
    rng = make_accumulator(w, h, seed=1).rng
    outs = []
    for block, warps in ((64, 2), (128, 4), (256, 8)):
        monkeypatch.setattr(PM, "BLOCK", block)
        monkeypatch.setattr(PM, "NUM_WARPS", warps)
        outs.append(trace_inline_pallas(
            scene, rays, rng, num_bounces=3, spp=1, interpret=True))
    assert outs[0][0].shape == (h, w, 3) and outs[0][1].shape == (h, w, 4)
    for rad, rng_out in outs[1:]:
        np.testing.assert_array_equal(np.asarray(rad), np.asarray(outs[0][0]))
        np.testing.assert_array_equal(
            np.asarray(rng_out), np.asarray(outs[0][1])
        )


def test_dielectric_elision_is_bit_exact():
    """has_dielectric=False must be bit-identical on glass-free scenes
    (the glass block draws no RNG, so eliding it changes nothing)."""
    scene, cam = world.main_scene(), world.initial_camera()
    a = render_batch_pallas(
        scene, cam, make_accumulator(W, H, seed=5), 2,
        num_bounces=6, interpret=True, has_dielectric=True,
    )
    b = render_batch_pallas(
        scene, cam, make_accumulator(W, H, seed=5), 2,
        num_bounces=6, interpret=True, has_dielectric=False,
    )
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))


def test_auto_detect_dielectric_flag():
    """The static glass flag is derived host-side from concrete scenes."""
    from haskell_path_tracer.ops.pallas_megakernel import scene_has_dielectric
    from haskell_path_tracer.render.renderer import Renderer

    assert Renderer._scene_has_dielectric(world.main_scene()) is False
    assert scene_has_dielectric(nee_scenes.glassy()) is True


def _mixed_scene():
    """All four primitive kinds, incl. an emissive triangle and a glossy
    box — exercises the 16-column geometry table and the static kind
    dispatch in the kernel's unrolled fold."""
    from haskell_path_tracer.models.objects import (
        BRDF_GLOSSY,
        BRDF_MATTE,
        Scene,
        make_boxes,
        make_materials,
        make_planes,
        make_spheres,
        make_triangles,
    )

    spheres = make_spheres(
        [[0.0, 0.5, -9.0], [3.0, 4.0, -8.0]],
        [1.0, 0.8],
        make_materials(
            [
                ([0.9, 0.3, 0.3], 0.0, BRDF_MATTE, 1.2),
                ([1.0, 1.0, 0.9], 80.0, BRDF_MATTE, 1.0),
            ]
        ),
    )
    planes = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.4, 0.7, 0.4], 0.0, BRDF_MATTE, 1.5)]),
    )
    boxes = make_boxes(
        [[-3.5, -3.0, -8.0]],
        [[-1.5, -0.5, -6.0]],
        make_materials([([0.3, 0.3, 0.9], 0.0, BRDF_GLOSSY, 0.9)]),
    )
    tris = make_triangles(
        [[1.0, -3.0, -6.0]],
        [[4.0, -3.0, -6.5]],
        [[2.5, 0.5, -7.0]],
        make_materials([([0.9, 0.8, 0.2], 5.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=spheres, planes=planes, boxes=boxes, triangles=tris)


def test_pallas_matches_xla_mixed_kinds():
    """Boxes/triangles fold inside the megakernel: same scene through the
    XLA inline path and the Pallas kernel."""
    scene = _mixed_scene()
    ref = render_batch_inline(
        scene, FRONT, make_accumulator(W, H, seed=11), 2, num_bounces=5
    )
    out = render_batch_pallas(
        scene, FRONT, make_accumulator(W, H, seed=11), 2, num_bounces=5,
        interpret=True,
    )
    rng_match = (
        (np.asarray(ref.rng) == np.asarray(out.rng)).all(axis=-1).mean()
    )
    assert rng_match > 0.995, rng_match
    close = np.isclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-4, atol=1e-4
    ).mean()
    assert close > 0.99, close


def test_pallas_mixed_kinds_hits_every_kind():
    """The mixed scene's kinds are all actually visible from the camera
    (guards the fixture against silently testing nothing)."""
    from haskell_path_tracer.ops.intersect import nearest_hit

    rays = primary_rays(FRONT, W, H)
    h = nearest_hit(rays.origin, rays.direction, _mixed_scene())
    prims = np.unique(np.asarray(h.prim)[np.asarray(h.hit)])
    # spheres are prims 0-1, plane 2, box 3, triangle 4
    assert {0, 2, 3, 4}.issubset(set(prims.tolist())), prims


def _glass_scene():
    """Two dielectric spheres in front of an emissive back wall."""
    from haskell_path_tracer.models.objects import (
        BRDF_DIELECTRIC,
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )

    s = make_spheres(
        [[0.0, 0.0, -4.0], [1.8, 0.5, -6.0]],
        [1.3, 0.9],
        make_materials(
            [([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5),
             ([0.9, 0.95, 1.0], 0.0, BRDF_DIELECTRIC, 1.33)]
        ),
    )
    p = make_planes(
        [[0.0, 0.0, -9.0], [0.0, -3.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
        make_materials(
            [([1.0, 0.9, 0.7], 3.0, BRDF_MATTE, 1.0),
             ([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)]
        ),
    )
    return Scene(spheres=s, planes=p)


SCENES = {
    "reference": (world.main_scene, world.initial_camera),
    "mixed_kinds": (_mixed_scene, lambda: FRONT),
    "glass": (_glass_scene, lambda: FRONT),
    "cornell8": (nee_scenes.cornell8, world.initial_camera),
}


@pytest.mark.parametrize("shape", [(128, 8), (200, 150), (130, 7)])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_xla_scene_and_shape(name, shape):
    """Four scenes x three shapes, two of them not a multiple of the lane
    block (a masked tail): bit-equal RNG and radiance to 1e-5 on >= 99.5%
    of lanes, the knife-edge contract of PARITY.md."""
    make_scene, make_cam = SCENES[name]
    scene, cam = make_scene(), make_cam()
    w, h = shape
    ref = render_batch_inline(
        scene, cam, make_accumulator(w, h, seed=4), 1, num_bounces=3
    )
    out = render_batch_pallas(
        scene, cam, make_accumulator(w, h, seed=4), 1, num_bounces=3,
        interpret=True,
    )
    assert out.color.shape == (h, w, 3)
    rng_eq = (np.asarray(ref.rng) == np.asarray(out.rng)).all(-1)
    close = np.isclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-5, atol=1e-6
    ).all(-1)
    assert rng_eq.mean() >= 0.995, rng_eq.mean()
    assert close.mean() >= 0.995, close.mean()
    assert np.abs(np.asarray(out.color)).max() > 0
