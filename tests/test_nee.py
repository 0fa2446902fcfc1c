"""Physical mode + next-event estimation tests.

Validates the corrected-BRDF sampling primitives (orthonormal basis,
cosine hemisphere, light-cone sampling) and the NEE estimator itself:
identical expectation to brute-force BSDF-sampling path tracing over the
same physical BRDFs, at a fraction of the variance (the whole point of
NEE — BASELINE.md config #4)."""

import numpy as np
import jax
import jax.numpy as jnp

from haskell_path_tracer.models.objects import (
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.render import nee as N
from haskell_path_tracer.render.integrator import make_accumulator

W, H = 20, 14


def light_scene(light_radius=0.5, illum=40.0):
    """Matte box-ish scene lit by one small bright sphere — the regime
    where BSDF sampling struggles and NEE shines."""
    s = make_spheres(
        [[0.0, 1.8, -5.0], [-0.8, -1.2, -4.5]],
        [light_radius, 0.9],
        make_materials(
            [
                ([1.0, 0.95, 0.8], illum, BRDF_MATTE, 1.0),
                ([0.7, 0.3, 0.3], 0.0, BRDF_MATTE, 1.0),
            ]
        ),
    )
    p = make_planes(
        [[0.0, -2.2, 0.0], [0.0, 0.0, -8.0]],
        [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
        make_materials(
            [
                ([0.6, 0.6, 0.6], 0.0, BRDF_MATTE, 1.0),
                ([0.4, 0.5, 0.7], 0.0, BRDF_MATTE, 1.0),
            ]
        ),
    )
    return Scene(spheres=s, planes=p)


def _camera():
    return Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)


# --- sampling primitives ---------------------------------------------------


def test_orthonormal_basis():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    b1, b2 = N._orthonormal_basis(jnp.asarray(w))
    b1, b2 = np.asarray(b1), np.asarray(b2)
    for a, b in [(b1, b2), (b1, w), (b2, w)]:
        np.testing.assert_allclose((a * b).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b1, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b2, axis=-1), 1.0, atol=1e-5)
    # Right-handed: b1 x b2 == w.
    np.testing.assert_allclose(np.cross(b1, b2), w, atol=1e-5)


def test_cosine_hemisphere_distribution():
    n = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (200_000, 3)
    )
    rng = np.random.default_rng(1)
    u1 = jnp.asarray(rng.uniform(size=200_000), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=200_000), jnp.float32)
    d = np.asarray(N.sample_cosine_hemisphere(n, u1, u2))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    assert (d[:, 2] > 0).all()  # upper hemisphere
    # E[cos(theta)] = 2/3 for a cosine-weighted density.
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=3e-3)
    # Azimuthal symmetry.
    assert abs(d[:, 0].mean()) < 3e-3 and abs(d[:, 1].mean()) < 3e-3


def test_light_cone_sampling_geometry():
    scene = light_scene(light_radius=0.5)
    point = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0], jnp.float32), (50_000, 3)
    )
    rng = np.random.default_rng(2)
    us = jnp.asarray(rng.uniform(size=50_000), jnp.float32)
    u1 = jnp.asarray(rng.uniform(size=50_000), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=50_000), jnp.float32)
    d, inv_pdf, idx = N.sample_light_cone(scene, point, us, u1, u2)
    d, inv_pdf, idx = np.asarray(d), np.asarray(inv_pdf), np.asarray(idx)

    # Only the emissive sphere (index 0) is ever selected.
    assert (idx == 0).all()
    center = np.array([0.0, 1.8, -5.0])
    dc = np.linalg.norm(center)
    cos_max = np.sqrt(1 - (0.5 / dc) ** 2)
    w = center / dc
    # Every sample lies inside the cone.
    cos_t = d @ w
    assert (cos_t >= cos_max - 1e-5).all()
    # inv_pdf = solid angle * num_lights (1 light).
    np.testing.assert_allclose(
        inv_pdf, 2 * np.pi * (1 - cos_max), rtol=5e-5
    )
    # Every sampled shadow ray actually hits the light sphere.
    from haskell_path_tracer.ops.intersect import sphere_distances

    t = np.asarray(sphere_distances(point, jnp.asarray(d), scene.spheres))
    assert (t[:, 0] < np.finfo(np.float32).max).mean() > 0.999


# --- estimator equivalence -------------------------------------------------


def _mean_image(scene, camera, spp, nee, seed, bounces=4):
    @jax.jit
    def run(acc):
        return N.render_batch_physical(
            scene, camera, acc, spp=spp, num_bounces=bounces, nee=nee
        )

    acc = run(make_accumulator(W, H, seed=seed))
    return np.asarray(acc.image)


def test_nee_matches_bruteforce_mean():
    """Same integral, two estimators: image means agree."""
    scene, camera = light_scene(light_radius=0.9), _camera()
    img_bf = _mean_image(scene, camera, spp=192, nee=False, seed=1)
    img_ne = _mean_image(scene, camera, spp=48, nee=True, seed=2)
    mb, mn = img_bf.mean(), img_ne.mean()
    assert abs(mb - mn) / mb < 0.08, (mb, mn)
    corr = np.corrcoef(img_bf.reshape(-1), img_ne.reshape(-1))[0, 1]
    assert corr > 0.95, corr


def test_nee_reduces_variance():
    """Per-sample variance of the NEE estimator is far below brute force
    for a small bright light."""
    scene, camera = light_scene(light_radius=0.25, illum=400.0), _camera()

    def per_sample_std(nee, seed, n=24):
        imgs = []
        acc = make_accumulator(W, H, seed=seed)
        step = jax.jit(
            lambda a: N.render_sample_physical(
                scene, camera, a, num_bounces=3, nee=nee
            )
        )
        prev = np.zeros((H, W, 3), np.float32)
        for _ in range(n):
            acc = step(acc)
            cur = np.asarray(acc.color)
            imgs.append(cur - prev)
            prev = cur
        return np.stack(imgs).std(axis=0).mean()

    s_bf = per_sample_std(False, seed=3)
    s_ne = per_sample_std(True, seed=4)
    assert s_ne < 0.5 * s_bf, (s_bf, s_ne)


def test_nee_finite_with_no_sphere_lights():
    """Plane-lit scene: NEE finds no sphere lights (inv_pdf = 0) and
    emission arrives through BSDF pickup; both estimators stay finite and
    agree."""
    s = make_spheres(
        [[0.0, 0.0, -5.0]],
        [1.0],
        make_materials([([0.8, 0.8, 0.8], 0.0, BRDF_MATTE, 1.0)]),
    )
    p = make_planes(
        [[0.0, 4.0, 0.0]],
        [[0.0, -1.0, 0.0]],
        make_materials([([1.0, 1.0, 1.0], 2.0, BRDF_MATTE, 1.0)]),
    )
    scene = Scene(spheres=s, planes=p)
    img_bf = _mean_image(scene, _camera(), spp=64, nee=False, seed=5)
    img_ne = _mean_image(scene, _camera(), spp=64, nee=True, seed=6)
    assert np.isfinite(img_ne).all()
    assert abs(img_bf.mean() - img_ne.mean()) / img_bf.mean() < 0.06


def test_specular_chain_sees_light():
    """Emission through specular chains must survive the NEE double-count
    rule: on a mirror-dominant scene the NEE estimator's mean must match
    brute force (which definitely collects mirror-reflected light).  If
    NEE wrongly suppressed emission after specular bounces, its image
    would be systematically darker."""
    s = make_spheres(
        [[0.0, 1.8, -5.0], [0.0, -0.5, -3.0]],
        [0.8, 0.9],
        make_materials(
            [
                ([1.0, 1.0, 1.0], 10.0, BRDF_MATTE, 1.0),
                ([0.95, 0.95, 0.95], 0.0, BRDF_GLOSSY, 1.0),
            ]
        ),
    )
    p = make_planes(
        [[0.0, -2.2, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.5, 0.5, 0.5], 0.0, BRDF_MATTE, 1.0)]),
    )
    scene = Scene(spheres=s, planes=p)
    img_bf = _mean_image(scene, _camera(), spp=96, nee=False, seed=7)
    img_ne = _mean_image(scene, _camera(), spp=96, nee=True, seed=8)
    mb, mn = img_bf.mean(), img_ne.mean()
    assert abs(mb - mn) / mb < 0.08, (mb, mn)


def test_stateless_threefry_matches_sfc32_mean():
    """The jax.random (threefry, counter-based) production path and the
    SFC32 state path estimate the same integral."""
    import jax.random as jr
    from haskell_path_tracer.models.camera import primary_rays

    scene, camera = light_scene(light_radius=0.9), _camera()
    rays = primary_rays(camera, W, H)
    img_tf = np.asarray(
        jax.jit(
            lambda k: N.trace_physical_stateless(
                scene, rays, k, num_bounces=4, spp=48, nee=True
            )
        )(jr.key(0))
    )
    img_sf = _mean_image(scene, camera, spp=48, nee=True, seed=9)
    assert np.isfinite(img_tf).all()
    mb, mn = img_sf.mean(), img_tf.mean()
    assert abs(mb - mn) / mb < 0.06, (mb, mn)
    corr = np.corrcoef(img_sf.reshape(-1), img_tf.reshape(-1))[0, 1]
    assert corr > 0.97, corr


def _tri_light_scene(illum=25.0):
    """Cornell-ceiling configuration: the only light is an emissive
    triangle overhead (NEE must not degrade to brute-force convergence
    here)."""
    from haskell_path_tracer.models.objects import make_triangles

    s = make_spheres(
        [[-0.8, -1.2, -4.5]],
        [0.9],
        make_materials([([0.7, 0.3, 0.3], 0.0, BRDF_MATTE, 1.0)]),
    )
    p = make_planes(
        [[0.0, -2.2, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.6], 0.0, BRDF_MATTE, 1.0)]),
    )
    # Ceiling triangle at y=3, wound so the geometric normal faces DOWN
    # (one-sided emitters: the front face is the lit side).
    tris = make_triangles(
        [[-2.5, 3.0, -6.5]],
        [[2.5, 3.0, -6.5]],
        [[0.0, 3.0, -2.5]],
        make_materials([([1.0, 0.95, 0.8], illum, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=s, planes=p, triangles=tris)


def test_triangle_light_normal_faces_down():
    scene = _tri_light_scene()
    tr = scene.triangles
    n = np.cross(
        np.asarray(tr.v1 - tr.v0)[0], np.asarray(tr.v2 - tr.v0)[0]
    )
    assert n[1] < 0, n


def test_nee_triangle_light_matches_bruteforce_mean():
    """Triangle-emitter NEE is the same integral as brute force."""
    scene, camera = _tri_light_scene(), _camera()
    img_bf = _mean_image(scene, camera, spp=256, nee=False, seed=1)
    img_ne = _mean_image(scene, camera, spp=48, nee=True, seed=2)
    mb, mn = img_bf.mean(), img_ne.mean()
    assert mb > 0.01, mb  # the light actually lights the scene
    assert abs(mb - mn) / mb < 0.1, (mb, mn)
    corr = np.corrcoef(img_bf.reshape(-1), img_ne.reshape(-1))[0, 1]
    assert corr > 0.9, corr


def test_nee_triangle_light_reduces_variance():
    scene, camera = _tri_light_scene(illum=200.0), _camera()

    def per_sample_std(nee, seed, n=16):
        imgs = []
        acc = make_accumulator(W, H, seed=seed)
        step = jax.jit(
            lambda a: N.render_sample_physical(
                scene, camera, a, num_bounces=3, nee=nee
            )
        )
        prev = np.zeros((H, W, 3), np.float32)
        for _ in range(n):
            acc = step(acc)
            cur = np.asarray(acc.color)
            imgs.append(cur - prev)
            prev = cur
        return np.stack(imgs).std(axis=0).mean()

    s_bf = per_sample_std(False, seed=3)
    s_ne = per_sample_std(True, seed=4)
    assert s_ne < 0.6 * s_bf, (s_bf, s_ne)


def test_sphere_only_light_table_unchanged():
    """Scenes without triangles keep the original sphere-only estimator
    (sample_light falls through to cone sampling, same draws)."""
    scene, camera = light_scene(), _camera()
    rays_shape = (H, W)
    from haskell_path_tracer.ops.rng import gen_seeds

    seeds = gen_seeds(rays_shape, seed=12)
    from haskell_path_tracer.models.camera import primary_rays

    rays = primary_rays(camera, W, H)
    img_a, rng_a = N.trace_physical(scene, rays, seeds, 3, nee=True)
    u = np.random.default_rng(0).uniform(0, 1, (3, H, W)).astype(np.float32)
    d1, p1, i1, _, _ = N.sample_light(scene, rays.origin, u[0], u[1], u[2])
    d2, p2, i2 = N.sample_light_cone(scene, rays.origin, u[0], u[1], u[2])
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
