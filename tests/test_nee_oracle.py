"""The XLA physical/NEE estimator (render/nee.py) against the independent
numpy oracle (parity/oracle_nee_np.py), lane for lane at matched RNG.

Covers sphere lights, triangle area lights, dielectrics, a scene lit only
by a plane, a scene above CHUNKED_THRESHOLD (the chunked nearest-hit fold
and the row-gather payload), and the stateless threefry sampler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nee_scenes
from haskell_path_tracer.models.camera import primary_rays
from haskell_path_tracer.models.objects import Camera
from haskell_path_tracer.ops import rng as rng_ops
from haskell_path_tracer.ops.intersect import CHUNKED_THRESHOLD
from haskell_path_tracer.parity import oracle_nee_np, oracle_np
from haskell_path_tracer.render.integrator import make_accumulator
from haskell_path_tracer.render.nee import (
    render_batch_physical_stateless,
    trace_physical,
)

H, W = 16, 64
FRONT = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
RAISED = Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0)

SCENES = {
    "cornell8": (nee_scenes.cornell8, FRONT),
    "glassy": (nee_scenes.glassy, FRONT),
    "zero_light": (nee_scenes.zero_light, FRONT),
    "tri_lights": (nee_scenes.tri_scene, FRONT),
    "chunked_200": (lambda: nee_scenes.big(200), RAISED),
}


def assert_lanes_agree(rng_a, rng_b, rad_a, rad_b):
    """Bit-equal RNG on >= 99.5% of lanes (a decision within an ulp of
    its boundary may flip between two independently written f32
    implementations), and radiance within 2e-3 wherever the RNG, i.e. the
    decision sequence, agrees."""
    match = (np.asarray(rng_a) == np.asarray(rng_b)).all(-1)
    assert match.mean() >= 0.995, match.mean()
    np.testing.assert_allclose(
        np.asarray(rad_a)[match], np.asarray(rad_b)[match],
        rtol=2e-3, atol=2e-3,
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_xla_estimator_matches_numpy_oracle(name):
    make, cam = SCENES[name]
    scene = make()
    rng0 = np.asarray(rng_ops.gen_seeds((H, W), seed=3))
    rays = primary_rays(cam, W, H)
    o_np, d_np = oracle_np.primary_rays_np(cam, W, H)
    rad_j, rng_j = trace_physical(
        scene, rays, jnp.asarray(rng0), num_bounces=3, nee=True
    )
    rad_n, rng_n = oracle_nee_np.trace_physical_np(
        scene, o_np, d_np, rng0.copy(), num_bounces=3
    )
    assert np.abs(rad_n).max() > 0  # light actually reaches the film
    assert_lanes_agree(rng_j, rng_n, rad_j, rad_n)


def test_chunked_scene_is_above_threshold():
    """Guards the chunked case against silently testing the small fold."""
    assert SCENES["chunked_200"][0]().num_primitives > CHUNKED_THRESHOLD


@pytest.mark.parametrize("iteration", [0, 5])
def test_threefry_sampler_matches_numpy_oracle(iteration):
    """The stateless sampler derives per-lane SFC32 states from (seed word,
    iteration) with threefry, burns them in, and runs the SFC32 estimator:
    one sample must equal the oracle fed the same derived states."""
    scene, cam = nee_scenes.cornell8(), FRONT
    acc = dataclasses.replace(
        make_accumulator(W, H, seed=9),
        iterations=jnp.asarray(iteration, jnp.int32),
    )
    out = render_batch_physical_stateless(
        scene, cam, acc, spp=1, num_bounces=3
    )
    key = jax.random.fold_in(
        jax.random.PRNGKey(acc.rng.reshape(-1, 4)[0, 0]), acc.iterations
    )
    states = jax.random.bits(key, (H, W, 4), jnp.uint32)
    for _ in range(12):
        _, states = rng_ops.sfc32_next(states)
    o_np, d_np = oracle_np.primary_rays_np(cam, W, H)
    rad_n, _ = oracle_nee_np.trace_physical_np(
        scene, o_np, d_np, np.asarray(states).copy(), num_bounces=3
    )
    np.testing.assert_array_equal(np.asarray(out.rng), np.asarray(acc.rng))
    close = np.isclose(
        np.asarray(out.color), rad_n, rtol=2e-3, atol=2e-3
    ).all(-1)
    assert close.mean() >= 0.995, close.mean()
