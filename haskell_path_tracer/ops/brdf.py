"""BRDF importance sampling: next-ray direction + throughput modifier.

Behavioral parity with `calcNextRay`
(upstream src/Scene/Trace.hs:394-435), reproducing the reference's
formulas verbatim — including the ones its author flags as "definitely not
correct" (Trace.hs:393) — because the parity target is the reference's
*behavior*:

  * Matte p: rotate the surface normal by a quaternion built from
    `pi * rot_vec` (three uniforms in [-1,1], x/y/z draw order); weight
    `b = p/pi * dot(next, normal)` (Trace.hs:407-411);
  * Glossy p: mirror-reflect, rotate the reflection by `(1-p) * rot_vec`;
    weight `b = max(0, dot(next, reflection))` (Trace.hs:419-429);
  * next ray starts `epsilon` along the new direction from the hit point
    (Trace.hs:431); throughput modifier = `color * b / (2*pi)`
    (Trace.hs:432-435).

Both branches are evaluated branchlessly and selected per lane with
`jnp.where` — a few extra vector flops instead of divergence, the right trade on
a SIMD machine.

Extension beyond the reference (it only stubbed this,
Trace.hs:116-118, 326-328): BRDF_DIELECTRIC — glass with Snell refraction,
total internal reflection and Schlick-Fresnel reflect/refract selection.  In
single-ray integrators the branch is chosen stochastically (reusing
`rot_vec.x` as the uniform so the per-bounce RNG draw count stays at exactly
3, preserving RNG parity for scenes without dielectrics); the wavefront
integrator can instead split the ray deterministically into both branches.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import linalg
from .intersect import EPSILON, Hit
from ..models.objects import BRDF_DIELECTRIC, BRDF_GLOSSY, BRDF_MATTE
from . import rng as rng_ops

INV_TWO_PI = np.float32(1.0 / (2.0 * np.pi))


def _matte_sample(normal, rot_vec, p):
    """Trace.hs:407-411."""
    q = linalg.angles_to_quaternion(jnp.pi * rot_vec)
    nxt = linalg.quat_rotate(q, normal)
    b = p / jnp.pi * linalg.dot(nxt, normal)
    return nxt, b


def _glossy_sample(ray_d, normal, rot_vec, p):
    """Trace.hs:419-429."""
    reflection = linalg.reflect(ray_d, normal)
    q = linalg.angles_to_quaternion((1.0 - p)[..., None] * rot_vec)
    nxt = linalg.quat_rotate(q, reflection)
    b = jnp.maximum(0.0, linalg.dot(nxt, reflection))
    return nxt, b


def dielectric_split(ray_d, normal, ior):
    """Glass: deterministic reflect/refract decomposition.

    Returns (refl_dir, refr_dir, reflect_weight) where `reflect_weight` is
    the Schlick-Fresnel reflectance (1.0 under total internal reflection,
    in which case `refr_dir` is a zero-weight placeholder).  An unbiased
    estimator either *splits* the ray into both branches with weights
    (F, 1-F) — the wavefront path (`render_sample_wavefront_split`), the
    capability the reference's `expand` stubbed
    (upstream src/Scene/Trace.hs:116-118) — or *chooses* one branch
    with probability F (the single-ray integrators via `sample`); the two
    estimators have identical expectation.
    """
    cos_i = -linalg.dot(ray_d, normal)
    inside = cos_i < 0.0
    # Flip the frame when the ray exits the medium.
    n = jnp.where(inside[..., None], -normal, normal)
    cos_i = jnp.abs(cos_i)
    eta = jnp.where(inside, ior, 1.0 / ior)  # n1/n2

    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    # Double-where: sqrt'(0) = inf would leak NaN into cotangents of the
    # other BRDF branches even though this value is masked out downstream.
    cos_t_arg = jnp.where(tir, 1.0, jnp.maximum(1.0 - sin2_t, 1e-12))
    cos_t = jnp.where(tir, 0.0, jnp.sqrt(cos_t_arg))

    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
    reflect_weight = jnp.where(tir, 1.0, fresnel)

    refl = linalg.reflect(ray_d, n)
    refr = linalg.normalize_safe(
        eta[..., None] * ray_d + (eta * cos_i - cos_t)[..., None] * n
    )
    return refl, refr, reflect_weight


def _dielectric_sample(ray_d, normal, u, ior):
    """Stochastic one-branch estimator of `dielectric_split`.

    `u` is a uniform in [0,1) per lane.  Returns (direction, weight) with
    weight 1: the branch choice is importance-sampled by the Fresnel
    probability, so the weights cancel.
    """
    refl, refr, reflect_prob = dielectric_split(ray_d, normal, ior)
    direction = jnp.where((u < reflect_prob)[..., None], refl, refr)
    return direction, jnp.ones_like(reflect_prob)


def sample(hit: Hit, ray_d: jnp.ndarray, rng_state: jnp.ndarray):
    """Sample the next bounce for a batch of hits.

    Returns (next_origin, next_direction, throughput_mod [...,3], new_state).
    Consumes exactly three RNG draws per lane (`genVec`, Util.hs:114-118).
    """
    rot_vec, new_state = rng_ops.gen_vec(rng_state)
    p = hit.brdf_param

    matte_dir, matte_b = _matte_sample(hit.normal, rot_vec, p)
    glossy_dir, glossy_b = _glossy_sample(ray_d, hit.normal, rot_vec, p)
    # Reuse rot_vec.x in [-1,1] -> [0,1) as the Fresnel uniform: keeps the
    # per-bounce draw count identical across materials (RNG parity).
    diel_u = (rot_vec[..., 0] + 1.0) * 0.5
    diel_dir, diel_b = _dielectric_sample(ray_d, hit.normal, diel_u, p)

    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    direction = jnp.where(
        is_diel[..., None],
        diel_dir,
        jnp.where(is_glossy[..., None], glossy_dir, matte_dir),
    )
    b = jnp.where(is_diel, diel_b, jnp.where(is_glossy, glossy_b, matte_b))

    origin = hit.point + direction * EPSILON
    # Parity scale: color * b / (2*pi) (Trace.hs:432-435).  The dielectric
    # extension is exempt from the 1/(2*pi) pdf (it is a delta BRDF).
    scale = jnp.where(is_diel, b, b * INV_TWO_PI)
    throughput_mod = hit.color * scale[..., None]
    return origin, direction, throughput_mod, new_state


def emittance(hit: Hit) -> jnp.ndarray:
    """emittance = color * illuminance (Trace.hs:319-320, 377-378)."""
    return hit.color * hit.illuminance[..., None]
