"""Sharded rendering/training on a virtual 8-device CPU mesh — the
multi-chip story tested without a cluster (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp

from haskell_path_tracer.diff import grad as G
from haskell_path_tracer.models import world
from haskell_path_tracer.ops.rng import gen_seeds
from haskell_path_tracer.parallel import mesh as M
from haskell_path_tracer.parallel.shard import (
    place_accumulator,
    render_radiance_sharded,
    render_sharded,
    train_step_sharded,
)
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_batch_inline,
)

W, H = 32, 24  # H divisible by 8 tiles


def test_virtual_devices_present():
    assert jax.device_count() >= 8


def test_tile_sharded_render_matches_single_device():
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()
    acc0 = make_accumulator(W, H, seed=4)
    ref = render_batch_inline(scene, cam, acc0, spp=2, num_bounces=4)

    acc_sh = place_accumulator(make_accumulator(W, H, seed=4), mesh)
    out = render_sharded(scene, cam, acc_sh, spp=2, mesh=mesh, num_bounces=4)

    np.testing.assert_array_equal(np.asarray(ref.rng), np.asarray(out.rng))
    np.testing.assert_allclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-6, atol=1e-6
    )


def test_tile_sample_mesh_radiance():
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh(n_tile=4, n_sample=2)
    rngs = jnp.stack([gen_seeds((H, W), seed=s) for s in (0, 1)])
    img = render_radiance_sharded(
        scene, cam, rngs, mesh, W, H, num_bounces=3, spp_per_shard=1
    )
    assert img.shape == (H, W, 3)
    # The sample-axis pmean of two independent single-sample renders equals
    # their host-side average.
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.render.integrator import trace_inline

    rays = primary_rays(cam, W, H)
    r0, _ = trace_inline(scene, rays, rngs[0], 3)
    r1, _ = trace_inline(scene, rays, rngs[1], 3)
    np.testing.assert_allclose(
        np.asarray(img), np.asarray((r0 + r1) / 2), rtol=1e-5, atol=1e-5
    )


def test_train_step_sharded_matches_single_device():
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()
    params = G.scene_to_params(scene)
    rng = gen_seeds((H, W), seed=9)
    target = G.render_radiance(scene, cam, rng, W, H, 3) * 0.5

    # single-device reference grads
    loss_fn = lambda p: G.image_loss(p, scene, cam, target, rng, num_bounces=3)
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)

    new_params, loss = train_step_sharded(
        params, scene, cam, target, rng, mesh, num_bounces=3, lr=0.1
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    expected = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, ref_grads)
    for a, b in zip(
        jax.tree_util.tree_leaves(new_params),
        jax.tree_util.tree_leaves(expected),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )


def test_train_step_sharded_pallas_matches_xla():
    """The fused Pallas fwd+bwd megakernel under shard_map + psum produces
    the same sharded gradients as the rematerialized XLA path: the fast
    gradient path reaches the distributed trainer.  Interpret mode stands
    in for the GPU on the CPU mesh."""
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()  # 8 tiles
    w, h = 128, 64
    params = G.scene_to_params(scene)
    rng = gen_seeds((h, w), seed=2)
    target = jnp.zeros((h, w, 3), jnp.float32) + 0.1

    out = {}
    for backend in ("xla", "pallas"):
        new_params, loss = train_step_sharded(
            params, scene, cam, target, rng, mesh, num_bounces=3, lr=0.1,
            backend=backend, interpret=True,
        )
        out[backend] = (new_params, float(loss))

    np.testing.assert_allclose(out["xla"][1], out["pallas"][1], rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(out["xla"][0]),
        jax.tree_util.tree_leaves(out["pallas"][0]),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-6
        )


def test_render_radiance_sharded_pallas_matches_xla():
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh(n_tile=4, n_sample=2)
    w, h = 128, 32
    rngs = jnp.stack([gen_seeds((h, w), seed=s) for s in (3, 4)])
    imgs = {
        b: np.asarray(
            render_radiance_sharded(
                scene, cam, rngs, mesh, w, h, num_bounces=3,
                spp_per_shard=1, backend=b, interpret=True,
            )
        )
        for b in ("xla", "pallas")
    }
    np.testing.assert_allclose(imgs["xla"], imgs["pallas"], rtol=1e-5,
                               atol=1e-5)


def test_wavefront_sharded_matches_single_device():
    """`--variant streams` under a mesh: the wavefront
    queue formulation row-shards cleanly (lane = pixel)."""
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()
    from haskell_path_tracer.render.wavefront import (
        render_batch_wavefront,
    )

    acc0 = make_accumulator(W, H, seed=6)
    ref = render_batch_wavefront(scene, cam, acc0, spp=2, num_bounces=4)

    acc_sh = place_accumulator(make_accumulator(W, H, seed=6), mesh)
    out = render_sharded(
        scene, cam, acc_sh, spp=2, mesh=mesh, num_bounces=4,
        algorithm="wavefront",
    )
    np.testing.assert_array_equal(np.asarray(ref.rng), np.asarray(out.rng))
    np.testing.assert_allclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-6, atol=1e-6
    )


def test_split_sharded_matches_single_device():
    """`--variant streams --split` under a mesh: deterministic dielectric
    splitting per shard (glass scene)."""
    from haskell_path_tracer.models.objects import (
        BRDF_DIELECTRIC,
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )
    from haskell_path_tracer.render.wavefront import (
        render_batch_wavefront_split,
    )

    s = make_spheres(
        [[0.0, 0.0, -4.0]], [1.4],
        make_materials([([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5)]),
    )
    p = make_planes(
        [[0.0, 0.0, -9.0], [0.0, -3.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
        make_materials(
            [([1.0, 0.9, 0.7], 3.0, BRDF_MATTE, 1.0),
             ([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)]
        ),
    )
    scene = Scene(spheres=s, planes=p)
    cam = world.initial_camera()
    mesh = M.make_mesh()

    acc0 = make_accumulator(W, H, seed=8)
    ref = render_batch_wavefront_split(
        scene, cam, acc0, spp=1, num_bounces=5, queue_factor=2.0
    )
    acc_sh = place_accumulator(make_accumulator(W, H, seed=8), mesh)
    out = render_sharded(
        scene, cam, acc_sh, spp=1, mesh=mesh, num_bounces=5,
        algorithm="split", queue_factor=2.0,
    )
    np.testing.assert_array_equal(np.asarray(ref.rng), np.asarray(out.rng))
    np.testing.assert_allclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-6, atol=1e-6
    )


def test_physical_sharded_matches_single_device():
    """`--variant physical` under a mesh: the NEE estimator row-shards
    with zero collectives (scene replicated, shadow rays on-chip)."""
    from haskell_path_tracer.render.nee import render_batch_physical

    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()
    acc0 = make_accumulator(W, H, seed=13)
    ref = render_batch_physical(scene, cam, acc0, spp=2, num_bounces=4)

    acc_sh = place_accumulator(make_accumulator(W, H, seed=13), mesh)
    out = render_sharded(
        scene, cam, acc_sh, spp=2, mesh=mesh, num_bounces=4,
        algorithm="physical",
    )
    np.testing.assert_array_equal(np.asarray(ref.rng), np.asarray(out.rng))
    np.testing.assert_allclose(
        np.asarray(ref.color), np.asarray(out.color), rtol=1e-5, atol=1e-5
    )


def test_train_step_sharded_physical_matches_single_device():
    """estimator="physical" reaches the distributed trainer: the sharded
    physical/NEE gradient step (XLA, the only route of that estimator)
    matches the single-device physical gradients."""
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()
    w, h = 128, 64
    params = G.scene_to_params(scene)
    rng = gen_seeds((h, w), seed=6)
    target = jnp.zeros((h, w, 3), jnp.float32) + 0.1

    loss_fn = lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=3, estimator="physical"
    )
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    expected = jax.tree_util.tree_map(
        lambda p, g: p - 0.1 * g, params, ref_grads
    )

    new_params, loss = train_step_sharded(
        params, scene, cam, target, rng, mesh, num_bounces=3, lr=0.1,
        backend="xla", estimator="physical",
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(new_params),
        jax.tree_util.tree_leaves(expected),
    ):
        # physical geometry grads reach ~1e3 with heavy cancellation;
        # per-tile partial sums + psum reorder the f32 reduction vs
        # the single-device mean, so tolerance is a bit looser here.
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-3, atol=1e-5
        )
