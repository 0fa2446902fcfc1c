"""Forward-render parity: JAX inline megakernel vs the independent numpy
oracle at matched SFC32 RNG (the in-repo stand-in for "allclose vs the
Accelerate CPU reference at matched RNG", BASELINE.md config #1).

Float32 trig/normalize differ by ulps between XLA and numpy, and a ray that
grazes a silhouette can diverge discretely, so the contract is: >= 99% of
pixels allclose, and the mean image tightly close.
"""

import numpy as np
import jax.numpy as jnp

from haskell_path_tracer.models import world
from haskell_path_tracer.models.camera import primary_rays
from haskell_path_tracer.models.objects import (
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops import rng as R
from haskell_path_tracer.parity import oracle_np
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_sample_inline,
)


def config1_scene():
    """BASELINE config #1: one diffuse sphere + ground plane."""
    s = make_spheres(
        [[0.0, 0.0, -6.0]],
        [2.0],
        make_materials([([0.8, 0.4, 0.4], 2.0, BRDF_MATTE, 0.8)]),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.43, 0.95, 0.5], 0.1, BRDF_MATTE, 1.5)]),
    )
    return Scene(spheres=s, planes=p)


def _run_parity(scene, camera, w, h, spp, bounces, seed):
    acc = make_accumulator(w, h, seed=seed)
    rng0 = np.asarray(acc.rng)

    jacc = acc
    for _ in range(spp):
        jacc = render_sample_inline(scene, camera, jacc, num_bounces=bounces)

    ncolor = np.zeros((h, w, 3), np.float32)
    nrng = rng0.copy()
    for _ in range(spp):
        ncolor, nrng = oracle_np.render_sample_np(
            scene, camera, ncolor, nrng, num_bounces=bounces
        )

    jcolor = np.asarray(jacc.color)
    jrng = np.asarray(jacc.rng)
    close = np.isclose(jcolor, ncolor, rtol=1e-3, atol=1e-3).all(axis=-1)
    frac = close.mean()
    rng_match = (jrng == nrng).all(axis=-1).mean()
    return frac, rng_match, jcolor, ncolor


def test_primary_rays_parity():
    cam = world.initial_camera()
    rays = primary_rays(cam, 64, 48)
    o, d = oracle_np.primary_rays_np(cam, 64, 48)
    np.testing.assert_allclose(np.asarray(rays.origin), o, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rays.direction), d, atol=1e-5)


def test_parity_config1():
    scene = config1_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    frac, rng_match, jc, nc = _run_parity(
        scene, cam, 64, 48, spp=4, bounces=2, seed=11
    )
    assert frac >= 0.99, f"only {frac:.4f} of pixels match"
    assert rng_match >= 0.99, f"only {rng_match:.4f} of rng states match"
    np.testing.assert_allclose(jc.mean(), nc.mean(), rtol=1e-3)


def test_parity_main_scene():
    """The reference's own 7-primitive scene, deeper bounces."""
    frac, rng_match, jc, nc = _run_parity(
        world.main_scene(),
        world.initial_camera(),
        48,
        32,
        spp=2,
        bounces=5,
        seed=3,
    )
    assert frac >= 0.98, f"only {frac:.4f} of pixels match"
    assert rng_match >= 0.98, f"only {rng_match:.4f} of rng states match"
