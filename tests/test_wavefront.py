"""Wavefront ≡ inline equivalence on split-free scenes.

The cross-check the reference never had (its Streams variant is documented
as buggy on GPU, /root/reference/src/Scene/Trace.hs:280-283): both
integrators implement identical termination/emission semantics, so on
scenes without ray splitting the radiance AND the per-pixel RNG states must
match bit-for-bit.
"""

import numpy as np
import jax.numpy as jnp

from haskell_path_tracer.models import world
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_sample_inline,
)
from haskell_path_tracer.render.wavefront import render_sample_wavefront


def _compare(
    scene,
    camera,
    w,
    h,
    bounces,
    samples=2,
    seed=5,
    russian_roulette=False,
):
    acc_i = make_accumulator(w, h, seed=seed)
    acc_w = make_accumulator(w, h, seed=seed)
    for _ in range(samples):
        acc_i = render_sample_inline(
            scene, camera, acc_i, num_bounces=bounces,
            russian_roulette=russian_roulette,
        )
        acc_w = render_sample_wavefront(
            scene, camera, acc_w, num_bounces=bounces,
            russian_roulette=russian_roulette,
        )
    np.testing.assert_array_equal(
        np.asarray(acc_i.rng), np.asarray(acc_w.rng), err_msg="rng mismatch"
    )
    np.testing.assert_allclose(
        np.asarray(acc_i.color),
        np.asarray(acc_w.color),
        rtol=1e-6,
        atol=1e-6,
        err_msg="radiance mismatch",
    )


def test_wavefront_equals_inline_main_scene():
    _compare(world.main_scene(), world.initial_camera(), 32, 24, bounces=6)


def test_wavefront_equals_inline_russian_roulette():
    _compare(
        world.main_scene(),
        world.initial_camera(),
        16,
        12,
        bounces=8,
        samples=1,
        russian_roulette=True,
    )


def test_wavefront_equals_inline_deep_bounces():
    _compare(world.main_scene(), world.initial_camera(), 16, 12, bounces=15, samples=1)


# --- occupancy telemetry (SURVEY.md §5: live-ray occupancy per wavefront
# step, bounce-depth histograms) ---------------------------------------------


def test_wavefront_stats_occupancy_invariants():
    from haskell_path_tracer.render.wavefront import (
        WavefrontStats,
        depth_histogram,
    )

    scene, camera = world.main_scene(), world.initial_camera()
    W_, H_, B = 32, 24, 8
    acc = make_accumulator(W_, H_, seed=7)
    out, stats = render_sample_wavefront(
        scene, camera, acc, num_bounces=B, return_stats=True
    )
    assert isinstance(stats, WavefrontStats)
    occ = np.asarray(stats.occupancy)
    assert occ.shape == (B + 1,)
    assert stats.capacity == W_ * H_
    # Every primary enters bounce 0; population never grows (no splitting).
    assert occ[0] == W_ * H_
    assert (np.diff(occ) <= 0).all()
    assert (occ >= 0).all()
    # Histogram partitions the primaries by path depth.
    hist = np.asarray(depth_histogram(stats))
    assert hist.shape == (B + 1,)
    assert (hist >= 0).all()
    assert hist.sum() == W_ * H_
    # Stats collection must not perturb the render.
    ref = render_sample_wavefront(scene, camera, acc, num_bounces=B)
    np.testing.assert_array_equal(np.asarray(ref.color), np.asarray(out.color))
    np.testing.assert_array_equal(np.asarray(ref.rng), np.asarray(out.rng))


def test_wavefront_batch_stats_sum_over_samples():
    from haskell_path_tracer.render.wavefront import (
        render_batch_wavefront,
    )

    scene, camera = world.main_scene(), world.initial_camera()
    W_, H_, B, SPP = 16, 12, 6, 3
    acc = make_accumulator(W_, H_, seed=3)
    out, stats = render_batch_wavefront(
        scene, camera, acc, spp=SPP, num_bounces=B, return_stats=True
    )
    occ = np.asarray(stats.occupancy)
    assert occ[0] == SPP * W_ * H_
    assert (np.diff(occ) <= 0).all()
    ref = render_batch_wavefront(scene, camera, acc, spp=SPP, num_bounces=B)
    np.testing.assert_array_equal(np.asarray(ref.color), np.asarray(out.color))


def test_wavefront_split_stats_can_grow():
    """With ray splitting the population may exceed the primary count (the
    queue enqueues refraction children), bounded by capacity."""
    from haskell_path_tracer.models.objects import BRDF_DIELECTRIC
    from haskell_path_tracer.render.wavefront import (
        render_sample_wavefront_split,
    )

    import dataclasses

    scene, camera = world.main_scene(), world.initial_camera()
    # Turn the big matte sphere into glass so splits actually occur.
    mat = scene.spheres.material
    mat = dataclasses.replace(
        mat,
        brdf_kind=mat.brdf_kind.at[0].set(BRDF_DIELECTRIC),
        brdf_param=mat.brdf_param.at[0].set(1.5),
    )
    scene = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, material=mat)
    )

    W_, H_, B = 24, 16, 8
    acc = make_accumulator(W_, H_, seed=11)
    out, stats = render_sample_wavefront_split(
        scene, camera, acc, num_bounces=B, return_stats=True
    )
    occ = np.asarray(stats.occupancy)
    assert occ.shape == (B + 1,)
    assert occ[0] == W_ * H_
    assert (occ <= stats.capacity).all()
    # Splitting happened: the per-depth segment counts include refraction
    # children, so total segments exceed what the monotone-decay plain
    # wavefront could ever produce at the same depths... which at tiny
    # sizes reduces to: some depth > 0 still carries segments and capacity
    # reflects the work cap (pixels * traversal steps).
    max_steps = B * (1 + 2)  # default queue_factor=2.0 -> 2 stack slots
    assert stats.capacity == W_ * H_ * max_steps
    assert occ[1:].sum() > 0
    ref = render_sample_wavefront_split(scene, camera, acc, num_bounces=B)
    np.testing.assert_array_equal(np.asarray(ref.color), np.asarray(out.color))


