"""Physically-based mode with next-event estimation (NEE).

The reference's BRDF math is self-admittedly wrong
(upstream src/Scene/Trace.hs:393: "definitely not correct") and its
only light transport is blind BSDF sampling.  SURVEY.md §7 ("hard parts")
commits this framework to exposing *corrected* BRDFs behind a flag next to
the parity path — this module is that flag, plus explicit light sampling:

  * Matte surfaces use true Lambertian cosine-weighted sampling
    (pdf = cos/pi, so the throughput modifier is exactly the albedo);
  * Glossy surfaces are perfect mirrors tinted by albedo (a delta lobe —
    the physical idealization of the reference's jittered reflection);
  * Dielectrics reuse the Fresnel-stochastic glass of `ops/brdf.py`;
  * At every matte hit a shadow ray samples one emitter — spheres by
    uniform cone (solid-angle) sampling, triangles by uniform area
    sampling (the Cornell-ceiling case) — the classic NEE estimator.
    Emission is then collected from BSDF hits only when the previous
    bounce was specular (or the emitter is a plane/box, which NEE does
    not sample: planes have infinite extent, boxes fall back to BSDF
    pickup), which makes the estimator unbiased with no double counting.

NEE is what makes small bright lights tractable (the reference's scene has
two — upstream src/Scene/World.hs with illuminance 6942/4420 — and
pure BSDF sampling almost never finds them); it is also the benchmark
requirement of BASELINE.md config #4 (1080p / 1k spheres / NEE / 256 spp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Accumulator,
    Camera,
    Rays,
    Scene,
)
from ..ops import brdf as brdf_ops
from ..ops import rng as rng_ops
from ..ops.intersect import (
    CHUNKED_THRESHOLD,
    EPSILON,
    INFINITE,
    hit_from_t_prim,
    nearest_t_prim,
    shadow_occluded,
)

TWO_PI = np.float32(2.0 * np.pi)


def _orthonormal_basis(w):
    """Branchless ONB around unit vector w (Duff et al. 2017). Returns
    (b1, b2) with (b1, b2, w) right-handed orthonormal."""
    z = w[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = w[..., 0] * w[..., 1] * a
    b1 = jnp.stack(
        [1.0 + sign * w[..., 0] ** 2 * a, sign * b, -sign * w[..., 0]],
        axis=-1,
    )
    b2 = jnp.stack([b, sign + w[..., 1] ** 2 * a, -w[..., 1]], axis=-1)
    return b1, b2


def sample_cosine_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about `normal`; pdf = cos(theta)/pi."""
    r = jnp.sqrt(u1)
    phi = TWO_PI * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 1e-12))
    b1, b2 = _orthonormal_basis(normal)
    return (
        b1 * x[..., None] + b2 * y[..., None] + normal * z[..., None]
    )


def _present_kinds(scene: Scene):
    """The set of BRDF kinds present in the scene, as a static host fact —
    or None when material arrays are traced (compute every branch).  Same
    pattern as the megakernel's `has_dielectric` auto-detect: a concrete
    scene lets XLA elide the absent branches' op chains entirely (the
    dielectric block alone is ~50 vector ops/lane), and the elision draws no
    RNG so it never changes results."""
    kind_arrays = [
        part.material.brdf_kind
        for part in (scene.spheres, scene.planes, scene.boxes,
                     scene.triangles)
        if part.count
    ]
    if any(isinstance(k, jax.core.Tracer) for k in kind_arrays):
        return None
    present = set()
    for k in kind_arrays:
        present.update(np.unique(np.asarray(k)).tolist())
    return frozenset(present)


def _physical_bounce(hit, ray_d, u1, u2, u3, kinds=None):
    """Shared direction selection for the physical BRDFs given three
    uniforms in [0, 1).  Returns (origin, direction, tmod, is_specular).

    Lambert: (albedo/pi) * cos / (cos/pi) = albedo.  Mirror/glass: albedo
    (delta lobes; the Fresnel branch choice is importance-sampled by u3).
    `kinds` (static) elides absent-material branches; None computes all.

    Shade-frame convention (the whole physical/NEE family, round 5): the
    next ray starts AT the hit point and intersection queries accept
    `t >= EPSILON` (`reject_below`), instead of the parity family's
    eps-shifted origin with `t >= 0`.  The two describe the same accept
    set in exact arithmetic; sharing ONE f32 formulation across the XLA
    estimator, the numpy oracle and the native oracle is what makes
    their per-lane parity structural rather than statistical.
    """
    has_glossy = kinds is None or BRDF_GLOSSY in kinds
    has_diel = kinds is None or BRDF_DIELECTRIC in kinds

    direction = sample_cosine_hemisphere(hit.normal, u1, u2)
    is_glossy = hit.brdf_kind == BRDF_GLOSSY
    is_diel = hit.brdf_kind == BRDF_DIELECTRIC
    if has_glossy:
        glossy_dir = linalg.reflect(ray_d, hit.normal)
        direction = jnp.where(is_glossy[..., None], glossy_dir, direction)
    if has_diel:
        refl, refr, f_refl = brdf_ops.dielectric_split(
            ray_d, hit.normal, hit.brdf_param
        )
        diel_dir = jnp.where((u3 < f_refl)[..., None], refl, refr)
        direction = jnp.where(is_diel[..., None], diel_dir, direction)

    if has_glossy or has_diel:
        is_specular = is_glossy | is_diel
    else:
        is_specular = jnp.zeros(hit.brdf_kind.shape, bool)
    return hit.point, direction, hit.color, is_specular


def sample_physical(hit, ray_d, rng_state, kinds=None):
    """Physically-based bounce sampling (three SFC32 draws per lane).

    Returns (origin, direction, throughput_mod, is_specular, new_state).
    """
    u, rng = rng_ops.gen_vec(rng_state)  # 3 draws in [-1, 1]
    origin, direction, tmod, is_specular = _physical_bounce(
        hit,
        ray_d,
        (u[..., 0] + 1.0) * 0.5,
        (u[..., 1] + 1.0) * 0.5,
        (u[..., 2] + 1.0) * 0.5,
        kinds=kinds,
    )
    return origin, direction, tmod, is_specular, rng


def _light_fields(scene: Scene):
    """NEE-sampled emitter table over spheres ++ triangles (index space:
    all spheres, then all triangles; non-emissive entries masked out).
    Planes cannot be area-sampled (infinite extent) and boxes are left to
    BSDF pickup; both stay unbiased via the emission-collection rule in
    `trace_physical` (`take_emit`).  Returns (mask [L], cdf [L], count)."""
    masks = [scene.spheres.material.illuminance > 0.0]
    if scene.triangles.count:
        masks.append(scene.triangles.material.illuminance > 0.0)
    mask = jnp.concatenate(masks) if len(masks) > 1 else masks[0]
    count = jnp.sum(mask.astype(jnp.float32))
    cdf = jnp.cumsum(mask.astype(jnp.float32))
    return mask, cdf, count


def _cone_sample(center, radius, point, u1, u2):
    """Uniform direction in the cone subtended by a sphere seen from
    `point`; returns (dir, solid_angle) with solid_angle = 1/pdf_dir.

    Numerically robust form (round 5): the naive `1 - cos_max` is a
    catastrophic cancellation for distant lights (sin2_max ~ (r/d)^2
    small, cos_max ~ 1): a 1-ulp difference in cos_max becomes a ~1e-3
    RELATIVE difference in the solid angle, which two differently
    compiled graphs of the same formula will hit (XLA's mul+add
    contraction is graph-context-dependent).  Both the one-minus terms
    are therefore computed directly:
        omc = 1 - cos_max = sin2_max / (1 + cos_max)
        st2 = 1 - cos_t^2 = (u1 * omc) * (1 + cos_t)
    — exact algebraic identities, each well-conditioned.  Every
    implementation of the estimator (XLA here, the numpy and native
    oracles) uses this exact sequence."""
    to_c = center - point
    dc2 = linalg.quadrance(to_c)
    dc = jnp.sqrt(jnp.maximum(dc2, 1e-12))
    sin2_max = jnp.clip(radius * radius / jnp.maximum(dc2, 1e-12), 0.0, 1.0)
    # Double-where: sqrt'(0) = inf would turn the zero cotangent of a
    # masked lane into NaN (0 * inf) in the backward sweep.  A shade
    # point ON/INSIDE the sampled sphere (sin2_max == 1) hits this —
    # e.g. light-sampling the emitter a lane just landed on, or the
    # discarded cone branch of a triangle-light lane.
    on_sphere = sin2_max >= 1.0
    cos_max = jnp.where(
        on_sphere,
        0.0,
        jnp.sqrt(jnp.where(on_sphere, 1.0, 1.0 - sin2_max)),
    )
    omc = jnp.where(on_sphere, 1.0, sin2_max / (1.0 + cos_max))

    x = u1 * omc
    cos_t = 1.0 - x
    st2 = x * (1.0 + cos_t)
    st_ok = st2 > 0.0
    sin_t = jnp.where(st_ok, jnp.sqrt(jnp.where(st_ok, st2, 1.0)), 0.0)
    phi = TWO_PI * u2
    w = to_c / dc[..., None]
    b1, b2 = _orthonormal_basis(w)
    direction = (
        b1 * (sin_t * jnp.cos(phi))[..., None]
        + b2 * (sin_t * jnp.sin(phi))[..., None]
        + w * cos_t[..., None]
    )
    return direction, TWO_PI * omc


def _tri_area_sample(tris, t_idx, point, u1, u2):
    """Uniform point on triangle `t_idx`, converted to a solid-angle
    sample at `point`.  Returns (dir, inv_pdf_dir) — inv_pdf_dir =
    A * cos_l / d^2, zero when the shade point faces the back side
    (one-sided triangles emit from the front face only, matching the
    intersection cull in ops/intersect.py:triangle_distances)."""
    v0 = tris.v0[t_idx]
    e1 = tris.v1[t_idx] - v0
    e2 = tris.v2[t_idx] - v0
    n = jnp.cross(e1, e2)
    n_norm = jnp.sqrt(jnp.maximum(linalg.quadrance(n), 1e-20))
    n_unit = n / n_norm[..., None]
    area = 0.5 * n_norm

    r1s = jnp.sqrt(jnp.maximum(u1, 1e-12))
    bu = 1.0 - r1s
    bv = u2 * r1s
    q = v0 + e1 * bu[..., None] + e2 * bv[..., None]
    to_q = q - point
    d2 = jnp.maximum(linalg.quadrance(to_q), 1e-12)
    direction = to_q / jnp.sqrt(d2)[..., None]
    cos_l = -linalg.dot(direction, n_unit)  # front face faces the point
    # Self-sampling guard: a shade point ON the emitter sampling its own
    # surface has true cos_l = 0 (coplanar), but fp noise in the hit
    # point makes cos_l ~ eps/|to_q|, and 1/d^2 then diverges as the
    # sampled point approaches the shade point (unbounded radiance, NaN
    # gradients).  Samples closer than the tracer's own geometric
    # resolution (2 * the self-intersection offset) are rejected — below
    # that distance the surface model has no meaning anyway.
    # KNOWN BIAS (accepted): the rejection zeroes the sample
    # without renormalizing the pdf, and matte lanes get no BSDF-pickup
    # compensation under NEE — shade points within 2*EPSILON of a
    # triangle emitter are darkened by the rejected mass.  The dead zone
    # is ~2e-4 scene units wide; the alternative (clamping d2 to min_d2)
    # bounds the estimator but biases *bright* instead and was rejected
    # because it perturbs every near-light sample, not just the zone.
    min_d2 = np.float32((2.0 * EPSILON) ** 2)
    inv_pdf = jnp.where(
        (cos_l > 1e-6) & (d2 >= min_d2), area * cos_l / d2, 0.0
    )
    return direction, inv_pdf


def _tri_t_single(tris, t_idx, point, l_dir, reject_below=EPSILON):
    """Möller–Trumbore distance from `point` to ONE triangle per lane
    (exactly `triangle_distances` restricted to the selected row — same
    f32 op sequence, so the NEE shadow window [eps, t_l) sees the same
    value a full nearest-hit would).  INFINITE on miss."""
    v0 = tris.v0[t_idx]
    e1 = tris.v1[t_idx] - v0
    e2 = tris.v2[t_idx] - v0
    pvec = jnp.cross(l_dir, e2)
    det = linalg.dot(e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    tvec = point - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = linalg.dot(l_dir, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    n_norm = linalg.norm(jnp.cross(e1, e2))
    from ..ops.intersect import PLANE_DENOM_EPS

    miss = (
        (det <= PLANE_DENOM_EPS * n_norm)
        | (u < 0.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t < reject_below)
    )
    return jnp.where(miss, INFINITE, t)


def sample_light(scene: Scene, point, u_select, u1, u2):
    """Uniformly pick an NEE-sampled emitter (sphere or triangle), then
    sample a direction toward it — cone sampling for spheres, area
    sampling for triangles.

    Returns (dir [..., 3], inv_pdf [...], light_prim [...] i32,
    t_l [...], l_emit [..., 3]) where `light_prim` is the emitter's
    GLOBAL primitive index, `inv_pdf` folds in the 1/num_lights
    selection probability (contribution = f * cos * L_e * inv_pdf),
    `t_l` is the distance to the SELECTED emitter along `dir` with the
    shade-frame acceptance (`_sphere_t_single` / `_tri_t_single`;
    INFINITE when unreachable) and `l_emit` its emission color * scale.
    Lanes with no valid light get inv_pdf = 0.
    """
    mask, cdf, count = _light_fields(scene)
    # Uniform selection among lights: target rank in [1, count].
    rank = jnp.floor(u_select * count) + 1.0
    rank = jnp.clip(rank, 1.0, jnp.maximum(count, 1.0))
    light_idx = jnp.argmax(
        cdf[None, ...] >= rank[..., None], axis=-1
    ).astype(jnp.int32)

    ns = scene.spheres.count
    nt = scene.triangles.count
    sp_mat = scene.spheres.material
    if nt:
        is_tri = light_idx >= ns
        s_idx = jnp.clip(light_idx, 0, max(ns - 1, 0))
        t_idx = jnp.clip(light_idx - ns, 0, nt - 1)
        dir_s, sa_s = _cone_sample(
            scene.spheres.pos[s_idx],
            scene.spheres.radius[s_idx],
            point,
            u1,
            u2,
        )
        dir_t, ip_t = _tri_area_sample(scene.triangles, t_idx, point, u1, u2)
        direction = jnp.where(is_tri[..., None], dir_t, dir_s)
        inv_pdf_dir = jnp.where(is_tri, ip_t, sa_s)
        tri_base = ns + scene.planes.count + scene.boxes.count
        light_prim = jnp.where(is_tri, tri_base + t_idx, s_idx)
        t_l = jnp.where(
            is_tri,
            _tri_t_single(scene.triangles, t_idx, point, direction),
            _sphere_t_single(
                point, direction,
                scene.spheres.pos[s_idx], scene.spheres.radius[s_idx],
            ),
        )
        tr_mat = scene.triangles.material
        l_emit = jnp.where(
            is_tri[..., None],
            tr_mat.color[t_idx] * tr_mat.illuminance[t_idx][..., None],
            sp_mat.color[s_idx] * sp_mat.illuminance[s_idx][..., None],
        )
    else:
        direction, inv_pdf_dir = _cone_sample(
            scene.spheres.pos[light_idx],
            scene.spheres.radius[light_idx],
            point,
            u1,
            u2,
        )
        light_prim = light_idx
        t_l = _sphere_t_single(
            point, direction,
            scene.spheres.pos[light_idx], scene.spheres.radius[light_idx],
        )
        l_emit = (
            sp_mat.color[light_idx]
            * sp_mat.illuminance[light_idx][..., None]
        )

    # Invalid when: no lights, degenerate zero solid angle, or (spheres)
    # the shade point inside the light / (triangles) behind the emitter.
    valid = (count > 0) & (inv_pdf_dir > 1e-9)
    inv_pdf = jnp.where(valid, inv_pdf_dir * count, 0.0)
    return direction, inv_pdf, light_prim, t_l, l_emit


def sample_light_cone(scene: Scene, point, u_select, u1, u2):
    """Sphere-only light sampling (the original estimator), kept as the
    reference `sample_light` must reduce to on triangle-free scenes and
    for tests of the cone math."""
    mask, cdf, count = _light_fields(scene)
    rank = jnp.floor(u_select * count) + 1.0
    rank = jnp.clip(rank, 1.0, jnp.maximum(count, 1.0))
    light_idx = jnp.argmax(
        cdf[None, ...] >= rank[..., None], axis=-1
    ).astype(jnp.int32)
    direction, solid_angle = _cone_sample(
        scene.spheres.pos[light_idx],
        scene.spheres.radius[light_idx],
        point,
        u1,
        u2,
    )
    valid = (count > 0) & (solid_angle > 1e-9)
    inv_pdf = jnp.where(valid, solid_angle * count, 0.0)
    return direction, inv_pdf, light_idx


def _sphere_t_single(point, l_dir, center, radius, eps=EPSILON):
    """Closed-form distance from `point` to ONE sphere per lane along
    `l_dir`, with offset-origin acceptance in the unshifted frame
    (tca >= eps, d2 <= r^2, t >= eps — exactly `sphere_distances` queried
    from `point + eps * l_dir` with t reported from `point`).  INFINITE
    on miss.  O(rays) — used for the NEE light distance."""
    l = center - point
    tca = linalg.dot(l, l_dir)
    d2 = linalg.quadrance(l) - tca * tca
    r2 = radius * radius
    outside = d2 > r2
    thc = jnp.where(outside, 0.0, jnp.sqrt(jnp.where(outside, 1.0, jnp.maximum(r2 - d2, 1e-12))))
    t = tca - thc
    miss = (tca < eps) | outside | (t < eps)
    return jnp.where(miss, INFINITE, t)


def trace_physical(
    scene: Scene,
    rays: Rays,
    rng_state: jnp.ndarray,
    num_bounces: int = 8,
    nee: bool = True,
    kinds=None,
):
    """Physically-based path trace; returns (radiance, new rng).

    With `nee=False` this is brute-force BSDF-sampling path tracing over
    the corrected BRDFs — the ground-truth estimator the NEE path is
    validated against (tests/test_nee.py: identical means, far lower
    variance).
    """
    if kinds is None:
        kinds = _present_kinds(scene)
    n_spheres = scene.spheres.count
    # Primitives NEE can never sample as lights: planes (infinite extent)
    # and boxes.  Their emission always arrives via BSDF pickup; spheres
    # and triangles are light-sampled (`sample_light`), so their emission
    # counts only off specular chains.
    bsdf_only_lo = n_spheres
    bsdf_only_hi = n_spheres + scene.planes.count + scene.boxes.count
    use_gather = scene.num_primitives > CHUNKED_THRESHOLD

    # Shade-frame loop: the carry holds the NEXT bounce's resolved (t, prim), queried from
    # the unshifted hit point with `reject_below = EPSILON`, so every
    # implementation of this estimator runs one shared f32 formulation.
    def body(_, state):
        ray_o, ray_d, t, prim, rng, result, throughput, prev_spec = state
        hit = hit_from_t_prim(
            ray_o, ray_d, t, prim, scene, use_gather=use_gather
        )
        dead = linalg.near_zero(throughput) | ~hit.hit

        is_bsdf_only = (hit.prim >= bsdf_only_lo) & (
            hit.prim < bsdf_only_hi
        )
        if nee:
            take_emit = prev_spec | is_bsdf_only
        else:
            take_emit = jnp.ones_like(prev_spec)
        emit = brdf_ops.emittance(hit) * throughput
        new_result = result + jnp.where(take_emit[..., None], emit, 0.0)

        _, next_d, tmod, is_spec, rng2 = sample_physical(
            hit, ray_d, rng, kinds=kinds
        )

        if nee:
            un, rng2 = rng_ops.gen_vec(rng2)  # 3 draws in [-1, 1]
            us = (un + 1.0) * 0.5
            l_dir, inv_pdf, l_idx, t_l, l_emit = sample_light(
                scene, hit.point, us[..., 0], us[..., 1], us[..., 2]
            )
            occ = shadow_occluded(hit.point, l_dir, t_l, l_idx, scene)
            visible = ~occ & (t_l < INFINITE)
            cos_i = linalg.dot(l_dir, hit.normal)
            # Only matte surfaces have a non-delta BRDF to evaluate.
            is_matte = hit.brdf_kind == BRDF_MATTE
            w = (
                visible
                & is_matte
                & (cos_i > 0.0)
            )
            contrib = (
                throughput
                * (hit.color / jnp.pi)
                * l_emit
                * (cos_i * inv_pdf)[..., None]
            )
            new_result = new_result + jnp.where(w[..., None], contrib, 0.0)

        new_throughput = throughput * tmod
        t2, prim2 = nearest_t_prim(hit.point, next_d, scene, EPSILON)

        d3 = dead[..., None]
        return (
            jnp.where(d3, ray_o, hit.point),
            jnp.where(d3, ray_d, next_d),
            jnp.where(dead, t, t2),
            jnp.where(dead, prim, prim2),
            jnp.where(dead[..., None], rng, rng2),
            jnp.where(d3, result, new_result),
            jnp.where(d3, 0.0, new_throughput),
            jnp.where(dead, prev_spec, is_spec),
        )

    zeros = jnp.zeros_like(rays.origin)
    t0, prim0 = nearest_t_prim(rays.origin, rays.direction, scene)
    init = (
        rays.origin,
        rays.direction,
        t0,
        prim0,
        rng_state,
        zeros,
        jnp.ones_like(rays.origin),
        jnp.ones(rays.origin.shape[:-1], bool),  # camera rays see lights
    )
    state = jax.lax.fori_loop(0, num_bounces, body, init)
    return state[5], state[4]


def trace_physical_stateless(
    scene: Scene,
    rays: Rays,
    key,
    num_bounces: int = 8,
    spp: int = 1,
    nee: bool = True,
    kinds=None,
):
    """Physical trace with the idiomatic `jax.random` path: stateless
    counter-based threefry instead of per-pixel SFC32 state.

    Each (sample, bounce) derives its uniforms from `fold_in`s of one
    scalar key — no [H, W, 4] state array to carry, reseed, or
    checkpoint; replaying any sample needs only (key, index).  This is
    the production sampling path SURVEY.md §7 pairs with the SFC32
    parity path.  Returns the mean radiance over `spp` samples.
    """
    import jax.random as jr

    n_spheres = scene.spheres.count
    # Same emission-collection rule as `trace_physical`: planes/boxes are
    # BSDF-only emitters; spheres/triangles are light-sampled.
    bsdf_only_lo = n_spheres
    bsdf_only_hi = n_spheres + scene.planes.count + scene.boxes.count
    if kinds is None:
        kinds = _present_kinds(scene)
    shape = rays.origin.shape[:-1]

    def uniforms(sample_key, bounce, n):
        k = jr.fold_in(sample_key, bounce)
        return jr.uniform(k, (n, *shape), dtype=jnp.float32)

    use_gather = scene.num_primitives > CHUNKED_THRESHOLD

    def one_sample(sample_key):
        def body(i, state):
            ray_o, ray_d, t, prim, result, throughput, prev_spec = state
            hit = hit_from_t_prim(
                ray_o, ray_d, t, prim, scene, use_gather=use_gather
            )
            dead = linalg.near_zero(throughput) | ~hit.hit

            is_bsdf_only = (hit.prim >= bsdf_only_lo) & (
                hit.prim < bsdf_only_hi
            )
            take_emit = (prev_spec | is_bsdf_only) if nee else (
                jnp.ones_like(prev_spec)
            )
            emit = brdf_ops.emittance(hit) * throughput
            new_result = result + jnp.where(take_emit[..., None], emit, 0.0)

            u = uniforms(sample_key, i, 6)
            _, direction, tmod, is_spec = _physical_bounce(
                hit, ray_d, u[0], u[1], u[2], kinds=kinds
            )
            new_throughput = throughput * tmod

            if nee:
                l_dir, inv_pdf, l_idx, t_l, l_emit = sample_light(
                    scene, hit.point, u[3], u[4], u[5]
                )
                occ = shadow_occluded(hit.point, l_dir, t_l, l_idx, scene)
                cos_i = linalg.dot(l_dir, hit.normal)
                w = (
                    ~occ & (t_l < INFINITE)
                    & (hit.brdf_kind == BRDF_MATTE) & (cos_i > 0.0)
                )
                contrib = (
                    throughput * (hit.color / jnp.pi)
                    * l_emit
                    * (cos_i * inv_pdf)[..., None]
                )
                new_result = new_result + jnp.where(
                    w[..., None], contrib, 0.0
                )

            t2, prim2 = nearest_t_prim(hit.point, direction, scene, EPSILON)
            d3 = dead[..., None]
            return (
                jnp.where(d3, ray_o, hit.point),
                jnp.where(d3, ray_d, direction),
                jnp.where(dead, t, t2),
                jnp.where(dead, prim, prim2),
                jnp.where(d3, result, new_result),
                jnp.where(d3, 0.0, new_throughput),
                jnp.where(dead, prev_spec, is_spec),
            )

        t0, prim0 = nearest_t_prim(rays.origin, rays.direction, scene)
        init = (
            rays.origin,
            rays.direction,
            t0,
            prim0,
            jnp.zeros_like(rays.origin),
            jnp.ones_like(rays.origin),
            jnp.ones(shape, bool),
        )
        state = jax.lax.fori_loop(0, num_bounces, body, init)
        return state[4]

    def sample_loop(i, acc):
        return acc + one_sample(jr.fold_in(key, i))

    total = jax.lax.fori_loop(
        0, spp, sample_loop, jnp.zeros((*shape, 3), jnp.float32)
    )
    return total / spp


def render_sample_physical(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset=0,
    full_height: int | None = None,
    kinds=None,
) -> Accumulator:
    """One progressive sample of the physical integrator into the
    accumulator (same contract as `render_sample_inline`).  `kinds` is
    the static BRDF-kind set for branch elision — pass it from OUTSIDE
    jit (e.g. `_present_kinds(scene)` on the concrete scene); under
    tracing the auto-detect sees only tracers and computes everything."""
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_physical(
        scene, rays, acc.rng, num_bounces, nee=nee, kinds=kinds
    )
    return Accumulator(
        color=acc.color + radiance,
        rng=rng_out,
        iterations=acc.iterations + 1,
    )


def render_batch_physical(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset=0,
    full_height: int | None = None,
    kinds=None,
) -> Accumulator:
    """`spp` physical/NEE samples in one on-device dispatch (an XLA
    sample loop over `render_sample_physical`)."""

    def body(_, a):
        return render_sample_physical(
            scene, camera, a, num_bounces, nee, row_offset, full_height,
            kinds=kinds,
        )

    return jax.lax.fori_loop(0, spp, body, acc)


def render_batch_physical_stateless(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 8,
    nee: bool = True,
    row_offset=0,
    full_height: int | None = None,
    kinds=None,
) -> Accumulator:
    """`spp` physical/NEE samples with STATELESS replay semantics — the
    production path selected by `RenderConfig.sampler = "threefry"`.

    The batch key derives from (one accumulator seed word, iteration
    count); `jax.random` (threefry) then derives the batch's per-lane
    SFC32 stream states as a pure function of that key, and the batch
    runs through the SAME machinery as the stateful path.  Any batch
    replays from (accumulator seed, iteration) alone; successive batches
    draw independent streams; the SFC32 parity state array rides along
    untouched (it is the parity sampler's state, not this one's).

    `trace_physical_stateless` (per-bounce threefry uniforms) remains
    the pure-`jax.random` reference estimator this path is validated
    against in expectation (tests/test_nee.py).
    """
    import jax.random as jr

    height, width = acc.color.shape[:2]
    key = jr.fold_in(
        jr.PRNGKey(acc.rng.reshape(-1, 4)[0, 0]), acc.iterations
    )
    states = jr.bits(key, (height, width, 4), jnp.uint32)
    # One seeding discipline for every fresh SFC32 state array: 12
    # burn-in rounds, exactly as `ops/rng.py:gen_seeds`
    # applies to its PCG64-filled states.  Threefry words are already
    # full-entropy, but the warm-up additionally decorrelates the first
    # *outputs* from the raw seed words (SFC32's t = a + b + counter is
    # a thin function of the seed on round one) and keeps the two
    # seeding paths identical in spec.  Cost: 12 vector rounds over
    # [H, W, 4], once per batch — noise next to a single bounce.
    for _ in range(12):
        _, states = rng_ops.sfc32_next(states)
    out = render_batch_physical(
        scene, camera,
        Accumulator(color=acc.color, rng=states,
                    iterations=acc.iterations),
        spp, num_bounces, nee=nee, row_offset=row_offset,
        full_height=full_height, kinds=kinds,
    )
    return Accumulator(
        color=out.color,
        rng=acc.rng,
        iterations=out.iterations,
    )
