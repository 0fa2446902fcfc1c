"""Pure-numpy oracle renderer: the reference's semantics, independently.

The north-star parity requirement is "forward renders allclose to the
Accelerate CPU reference at matched RNG" (BASELINE.md).  The Haskell
toolchain is not available in this environment, so this module is the
in-repo stand-in: a from-the-spec, float32, vectorized-numpy implementation
of the reference's `render Inline` pipeline
(upstream src/Scene/Trace.hs:193-200, 344-383), sharing *no* code
with the JAX path (separate RNG twin, separate math) so that structural bugs
on either side surface as mismatches.

Covered semantics (each cited to the reference):
  * primary rays — virtual screen plane, negated-height Y flip
    (Trace.hs:205-262, Util.hs:198-200);
  * sphere/plane intersection accept/reject rules (Intersection.hs:39-62);
  * nearest hit, first-primitive tie-break, t=inf miss (Trace.hs:443-451,
    Util.hs:171-178);
  * Matte/Glossy sampling, 1/(2*pi) pdf, epsilon offset (Trace.hs:394-435);
  * dead-lane freezing and throughput-nearZero termination
    (Trace.hs:364-365);
  * accumulation `new + old`, keep new seed (Trace.hs:193-196).
"""

from __future__ import annotations

import numpy as np

F = np.float32
PI = F(np.pi)
INFINITE = np.finfo(np.float32).max
EPSILON = F(0.002)


# --- RNG: independent scalar-ish SFC32 (vectorized, masked arithmetic) -----


def _sfc32(state):
    a, b, c, ctr = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    with np.errstate(over="ignore"):
        t = a + b + ctr
        ctr = ctr + np.uint32(1)
        a = b ^ (b >> np.uint32(9))
        b = c + (c << np.uint32(3))
        c = ((c << np.uint32(21)) | (c >> np.uint32(11))) + t
    return t, np.stack([a, b, c, ctr], axis=-1)


def _uniform(state):
    bits, state = _sfc32(state)
    return (bits >> np.uint32(8)).astype(F) * F(1.0 / (1 << 24)), state


def _gen_vec(state):
    x, state = _uniform(state)
    y, state = _uniform(state)
    z, state = _uniform(state)
    return np.stack([x, y, z], -1) * F(2) - F(1), state


# --- vector helpers (float32 throughout) -----------------------------------


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True).astype(F)


def _angles_to_quat(ang):
    roll, pitch, yaw = ang[..., 0], ang[..., 1], ang[..., 2]
    cy, sy = np.cos(yaw * F(0.5)), np.sin(yaw * F(0.5))
    cp, sp = np.cos(pitch * F(0.5)), np.sin(pitch * F(0.5))
    cr, sr = np.cos(roll * F(0.5)), np.sin(roll * F(0.5))
    return np.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            sy * cp * sr + cy * sp * cr,
            sy * cp * cr - cy * sp * sr,
        ],
        axis=-1,
    ).astype(F)


def _quat_rotate(q, v):
    w, u = q[..., 0:1], q[..., 1:4]
    t = np.cross(u, v).astype(F) * F(2)
    return v + w * t + np.cross(u, t).astype(F)


# --- scene access ----------------------------------------------------------


def _scene_np(scene):
    """Flatten a Scene pytree to plain numpy SoA dicts (spheres ++ planes)."""
    sp, pl = scene.spheres, scene.planes
    return {
        "s_pos": np.asarray(sp.pos, F),
        "s_rad": np.asarray(sp.radius, F),
        "p_pos": np.asarray(pl.pos, F),
        "p_nor": np.asarray(pl.normal, F),
        "color": np.concatenate(
            [np.asarray(sp.material.color, F), np.asarray(pl.material.color, F)]
        ),
        "illum": np.concatenate(
            [
                np.asarray(sp.material.illuminance, F),
                np.asarray(pl.material.illuminance, F),
            ]
        ),
        "kind": np.concatenate(
            [
                np.asarray(sp.material.brdf_kind),
                np.asarray(pl.material.brdf_kind),
            ]
        ),
        "param": np.concatenate(
            [
                np.asarray(sp.material.brdf_param, F),
                np.asarray(pl.material.brdf_param, F),
            ]
        ),
    }


def primary_rays_np(camera, width, height):
    """Trace.hs:205-262 in numpy.  Returns (origin [H,W,3], dir [H,W,3])."""
    pos = np.asarray(camera.position, F)
    rot = np.asarray(camera.rotation, F)
    fov = F(np.asarray(camera.fov))

    screen_angle = F(fov * PI / F(180) / F(2))
    screen_distance = F(1) / np.tan(screen_angle, dtype=F)
    screen_half_width = np.tan(screen_angle, dtype=F) * screen_distance

    forward = np.array([0, 0, -1], F)
    up = np.array([0, 1, 0], F)
    c_dir = _quat_rotate(_angles_to_quat(rot), forward)
    center = pos + c_dir * screen_distance
    center_offset = center - pos
    right = _normalize(np.cross(center_offset, up).astype(F)) / screen_half_width
    aspect = F(width) / F(height)
    top = np.cross(c_dir, right).astype(F) / aspect

    xs, ys = np.meshgrid(
        np.arange(width, dtype=F), np.arange(height, dtype=F)
    )
    sx = xs / F(width) * F(2) - F(1)
    sy = ys / F(-height) * F(2) + F(1)
    point = center + right * sx[..., None] + top * sy[..., None]
    d = _normalize(point - pos)
    o = np.broadcast_to(pos, d.shape).copy()
    return o, d


def _nearest_hit_np(o, d, S):
    ns = S["s_pos"].shape[0]
    # spheres (Intersection.hs:39-48)
    l = S["s_pos"] - o[..., None, :]
    tca = _dot(l, d[..., None, :])
    d2 = _dot(l, l) - tca * tca
    r2 = S["s_rad"] * S["s_rad"]
    with np.errstate(invalid="ignore"):
        thc = np.sqrt(np.maximum(r2 - d2, F(0)))
    t = tca - thc
    ts = np.where((tca < 0) | (d2 > r2) | (t < 0), INFINITE, t)
    # planes (Intersection.hs:57-62)
    denom = _dot(d[..., None, :], S["p_nor"])
    num = _dot(S["p_pos"] - o[..., None, :], S["p_nor"])
    with np.errstate(divide="ignore", invalid="ignore"):
        dist = num / np.where(denom == 0, F(5e-7), denom)
    tp = np.where((denom > F(1e-6)) | (dist < 0), INFINITE, dist)

    allt = np.concatenate([ts, tp], axis=-1)
    prim = np.argmin(allt, axis=-1)
    t = np.take_along_axis(allt, prim[..., None], axis=-1)[..., 0]
    hit = t < INFINITE

    point = o + d * np.where(hit, t, F(0))[..., None]
    is_sphere = prim < ns
    s_idx = np.minimum(prim, ns - 1)
    sn = _normalize(point - S["s_pos"][s_idx])
    if S["p_nor"].shape[0]:
        p_idx = np.clip(prim - ns, 0, S["p_nor"].shape[0] - 1)
        normal = np.where(is_sphere[..., None], sn, S["p_nor"][p_idx])
    else:
        # Plane-free scene: every hit is a sphere (found by the
        # three-way differential fuzzer — an empty p_nor was indexed).
        normal = sn
    return {
        "t": t,
        "hit": hit,
        "prim": prim,
        "point": point,
        "normal": normal,
        "color": S["color"][prim],
        "illum": S["illum"][prim],
        "kind": S["kind"][prim],
        "param": S["param"][prim],
    }


def _calc_next_ray_np(h, d, state):
    """Trace.hs:394-435."""
    rot_vec, state = _gen_vec(state)
    p = h["param"]
    normal = h["normal"]

    # Matte (Trace.hs:407-411)
    mq = _angles_to_quat(PI * rot_vec)
    m_dir = _quat_rotate(mq, normal)
    m_b = p / PI * _dot(m_dir, normal)

    # Glossy (Trace.hs:419-429)
    refl = d - F(2) * _dot(d, normal)[..., None] * normal
    gq = _angles_to_quat((F(1) - p)[..., None] * rot_vec)
    g_dir = _quat_rotate(gq, refl)
    g_b = np.maximum(F(0), _dot(g_dir, refl))

    glossy = h["kind"] == 1
    nxt = np.where(glossy[..., None], g_dir, m_dir)
    b = np.where(glossy, g_b, m_b)

    origin = h["point"] + nxt * EPSILON
    tmod = h["color"] * (b * F(1.0 / (2 * np.pi)))[..., None]
    return origin, nxt, tmod, state


def trace_inline_np(scene, o, d, rng_state, num_bounces):
    """Trace.hs:344-383 vectorized over the pixel grid."""
    S = _scene_np(scene)
    state = rng_state.copy()
    result = np.zeros_like(o)
    throughput = np.ones_like(o)
    for _ in range(num_bounces):
        h = _nearest_hit_np(o, d, S)
        dead = (_dot(throughput, throughput) <= F(1e-6)) | ~h["hit"]
        no, nd, tmod, state2 = _calc_next_ray_np(h, d, state)
        emit = h["color"] * h["illum"][..., None]
        new_result = result + emit * throughput
        new_throughput = throughput * tmod
        d3 = dead[..., None]
        o = np.where(d3, o, no)
        d = np.where(d3, d, nd)
        state = np.where(dead[..., None], state, state2)
        result = np.where(d3, result, new_result)
        throughput = np.where(d3, F(0), new_throughput)
    return result, state


def render_sample_np(scene, camera, color, rng_state, num_bounces=15):
    """One progressive sample: returns (color + radiance, new rng)."""
    h, w = color.shape[:2]
    o, d = primary_rays_np(camera, w, h)
    radiance, state = trace_inline_np(scene, o, d, rng_state, num_bounces)
    return color + radiance, state
