"""Dielectric ray splitting: the capability the reference stubbed
(`expand` with 0..N outputs per ray, /root/reference/src/Scene/Trace.hs:116-118,
326-328) — implemented here as deterministic Fresnel splitting in the
wavefront queue.

Checks: physics of the reflect/refract decomposition, exact equivalence
with the non-splitting integrators on split-free scenes, and statistical
agreement between the splitting and stochastic-branch estimators on a
glass scene (both are unbiased estimators of the same integral)."""

import numpy as np
import jax
import jax.numpy as jnp

from haskell_path_tracer.models import world
from haskell_path_tracer.models.objects import (
    BRDF_DIELECTRIC,
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops import brdf as brdf_ops
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_sample_inline,
)
from haskell_path_tracer.render.wavefront import (
    render_sample_wavefront,
    render_sample_wavefront_split,
)

W, H = 16, 12


def glass_scene(ior=1.5):
    """A glass sphere between the camera and an emissive back wall."""
    s = make_spheres(
        [[0.0, 0.0, -4.0]],
        [1.5],
        make_materials([([0.96, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, ior)]),
    )
    p = make_planes(
        [[0.0, 0.0, -9.0], [0.0, -3.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
        make_materials(
            [
                ([1.0, 0.9, 0.7], 3.0, BRDF_MATTE, 1.0),
                ([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2),
            ]
        ),
    )
    return Scene(spheres=s, planes=p)


def _camera():
    return Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)


# --- decomposition physics -------------------------------------------------


def test_dielectric_split_snell_and_energy():
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    # 45 degrees incidence, entering ior=1.5.
    d = jnp.asarray([[np.sin(np.pi / 4), 0.0, -np.cos(np.pi / 4)]], jnp.float32)
    refl, refr, f = brdf_ops.dielectric_split(d, n, jnp.asarray([1.5]))
    # Reflection mirrors the z component.
    np.testing.assert_allclose(
        np.asarray(refl[0]), [np.sin(np.pi / 4), 0, np.cos(np.pi / 4)], atol=1e-6
    )
    # Snell: sin(theta_t) = sin(theta_i) / 1.5.
    sin_t = float(jnp.linalg.norm(refr[0, :2]))
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-5)
    assert float(refr[0, 2]) < 0  # continues into the medium
    np.testing.assert_allclose(float(jnp.linalg.norm(refr[0])), 1.0, atol=1e-6)
    # Fresnel weight in (0, 1): both branches carry energy.
    assert 0.0 < float(f[0]) < 1.0


def test_dielectric_split_total_internal_reflection():
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    # Exiting the medium (direction has positive z -> cos_i < 0 -> inside)
    # at 80 degrees from the inward normal: sin_t = 1.5 * sin(80deg) > 1.
    ang = np.deg2rad(80.0)
    d = jnp.asarray([[np.sin(ang), 0.0, np.cos(ang)]], jnp.float32)
    refl, refr, f = brdf_ops.dielectric_split(d, n, jnp.asarray([1.5]))
    assert float(f[0]) == 1.0  # all energy reflects
    np.testing.assert_allclose(float(jnp.linalg.norm(refl[0])), 1.0, atol=1e-6)


def test_dielectric_normal_incidence_r0():
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    _, refr, f = brdf_ops.dielectric_split(d, n, jnp.asarray([1.5]))
    np.testing.assert_allclose(float(f[0]), ((1.5 - 1) / (1.5 + 1)) ** 2, atol=1e-6)
    np.testing.assert_allclose(np.asarray(refr[0]), [0, 0, -1], atol=1e-6)


# --- split-free equivalence ------------------------------------------------


def test_split_integrator_equals_wavefront_without_dielectrics():
    """With no glass in the scene no children ever spawn, and the splitting
    integrator must match the plain wavefront (and hence inline) BIT-FOR-BIT
    including RNG states."""
    scene, camera = world.main_scene(), world.initial_camera()
    acc0 = make_accumulator(W, H, seed=9)
    a = render_sample_wavefront(scene, camera, acc0, num_bounces=5)
    b = render_sample_wavefront_split(
        scene, camera, acc0, num_bounces=5, queue_factor=1.5
    )
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))
    np.testing.assert_allclose(
        np.asarray(a.color), np.asarray(b.color), rtol=1e-6, atol=1e-6
    )


# --- statistical equivalence on a glass scene ------------------------------


def test_split_expectation_matches_stochastic():
    """Split and stochastic-branch estimators target the same integral;
    their sample means over the image must agree."""
    scene, camera = glass_scene(), _camera()
    spp = 64

    @jax.jit
    def run_inline(acc):
        def body(_, a):
            return render_sample_inline(scene, camera, a, num_bounces=6)
        return jax.lax.fori_loop(0, spp, body, acc)

    @jax.jit
    def run_split(acc):
        def body(_, a):
            return render_sample_wavefront_split(
                scene, camera, a, num_bounces=6, queue_factor=4.0
            )
        return jax.lax.fori_loop(0, spp, body, acc)

    img_i = np.asarray(run_inline(make_accumulator(W, H, seed=1)).image)
    img_s = np.asarray(run_split(make_accumulator(W, H, seed=2)).image)

    assert np.isfinite(img_s).all()
    # Global mean radiance within a few percent (split has *less* variance).
    mi, ms = img_i.mean(), img_s.mean()
    assert abs(mi - ms) / mi < 0.06, (mi, ms)
    # Pixelwise: highly correlated images.
    corr = np.corrcoef(img_i.reshape(-1), img_s.reshape(-1))[0, 1]
    assert corr > 0.97, corr


def test_split_queue_overflow_is_safe():
    """queue_factor=1.0 leaves no spare capacity: children are dropped, the
    render stays finite and below the fully-split estimate."""
    scene, camera = glass_scene(), _camera()
    acc = make_accumulator(W, H, seed=3)
    tight = render_sample_wavefront_split(
        scene, camera, acc, num_bounces=5, queue_factor=1.0
    )
    roomy = render_sample_wavefront_split(
        scene, camera, acc, num_bounces=5, queue_factor=4.0
    )
    t, r = np.asarray(tight.color), np.asarray(roomy.color)
    assert np.isfinite(t).all()
    assert t.mean() <= r.mean() + 1e-6  # dropped children only remove energy
