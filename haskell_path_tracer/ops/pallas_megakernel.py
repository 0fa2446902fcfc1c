"""Parity megakernel for the GPU: the whole sample + bounce loop in one kernel.

The XLA inline integrator (render/integrator.py) runs every bounce as
separate fusions: each pixel's loop state (ray, throughput, SFC32 words,
radiance) goes out to device memory and back once per bounce, and a few
kernel launches are paid per bounce.  This kernel, written in Pallas for
the Triton route, gives each GPU thread its pixel for ALL samples and ALL
bounces: the state lives in registers, the only device-memory traffic is
reading the primary rays + RNG once and writing radiance + RNG once.

Semantics are identical to `trace_inline` (same op sequence, same SFC32
draws: the parity tests assert bit-equal RNG states and allclose
radiance), so this is a drop-in backend for the inline megakernel
(`render Inline`, upstream src/Scene/Trace.hs:193-200, 344-383).

Layout: the image is flattened to N pixels and cut into 1-D power-of-two
lane blocks (`BLOCK`), one program per block; the last block's tail lanes
re-read the last pixel and are masked at the store, so any width works.
The scene rides along as one flat f32 table, padded to a power of two and
read by scalar loads:
  geom  [P, 8|16]: sphere (cx, cy, cz, radius, 0...)
                   plane  (px, py, pz, nx, ny, nz, 0...)
                   box    (lox, loy, loz, hix, hiy, hiz, 0...)
                   triangle (v0, e1, e2, n_unit, |e1 x e2|, 0...)
  mat   [P, 8]:    (cr, cg, cb, illuminance, brdf_param, brdf_kind, 0, 0)
The per-primitive fold is unrolled at trace time (static P, static kind
dispatch), with compare-and-select folds for the nearest-hit payload.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.objects import BRDF_DIELECTRIC, Scene
from .intersect import EPSILON, INFINITE, PLANE_DENOM_EPS

INV_TWO_PI = np.float32(1.0 / (2.0 * np.pi))
NEAR_ZERO_EPS = np.float32(1e-6)
# Lanes (pixels) per program and warps per program.
BLOCK = 128
NUM_WARPS = 4


def _scene_tables(scene: Scene):
    """Pack the scene into (geom [P,8|16], mat [P,8]) f32 tables.

    Sphere+plane scenes use an 8-column geometry layout.  Scenes with
    boxes/triangles widen to 16 columns; the fold needs no kind column — primitive order
    is spheres ++ planes ++ boxes ++ triangles (Scene contract) with
    static counts, so the per-row kind dispatch happens at trace time:

      sphere    [cx, cy, cz, radius, 0...]
      plane     [px, py, pz, nx, ny, nz, 0...]
      box       [lox, loy, loz, hix, hiy, hiz, 0...]
      triangle  [v0(3), e1(3), e2(3), n_unit(3), |cross(e1,e2)|, 0...]
    """
    if scene.boxes.count or scene.triangles.count:
        return _scene_tables_extended(scene)
    ns = scene.spheres.count
    sm, pm = scene.spheres.material, scene.planes.material
    zeros_s = jnp.zeros((ns,), jnp.float32)
    geom_s = jnp.stack(
        [
            scene.spheres.pos[:, 0],
            scene.spheres.pos[:, 1],
            scene.spheres.pos[:, 2],
            scene.spheres.radius,
            zeros_s,
            zeros_s,
            zeros_s,
            jnp.ones((ns,), jnp.float32),
        ],
        axis=-1,
    )
    npl = scene.planes.count
    zeros_p = jnp.zeros((npl,), jnp.float32)
    geom_p = jnp.stack(
        [
            scene.planes.pos[:, 0],
            scene.planes.pos[:, 1],
            scene.planes.pos[:, 2],
            scene.planes.normal[:, 0],
            scene.planes.normal[:, 1],
            scene.planes.normal[:, 2],
            zeros_p,
            zeros_p,
        ],
        axis=-1,
    )
    geom = jnp.concatenate([geom_s, geom_p], axis=0)
    mat = jnp.concatenate([_mat_rows8(sm, ns), _mat_rows8(pm, npl)], axis=0)
    return geom, mat


def _mat_rows8(m, n):
    z = jnp.zeros((n,), jnp.float32)
    return jnp.stack(
        [
            m.color[:, 0],
            m.color[:, 1],
            m.color[:, 2],
            m.illuminance,
            m.brdf_param,
            m.brdf_kind.astype(jnp.float32),
            z,
            z,
        ],
        axis=-1,
    )


def _scene_tables_extended(scene: Scene):
    """16-column geometry packing for scenes with boxes/triangles."""
    cols = 16

    def pad(rows):
        n, c = rows.shape
        return jnp.concatenate(
            [rows, jnp.zeros((n, cols - c), jnp.float32)], axis=-1
        )

    parts_g, parts_m = [], []
    ns = scene.spheres.count
    if ns:
        parts_g.append(
            pad(
                jnp.concatenate(
                    [scene.spheres.pos, scene.spheres.radius[:, None]],
                    axis=-1,
                )
            )
        )
        parts_m.append(_mat_rows8(scene.spheres.material, ns))
    npl = scene.planes.count
    if npl:
        parts_g.append(
            pad(
                jnp.concatenate(
                    [scene.planes.pos, scene.planes.normal], axis=-1
                )
            )
        )
        parts_m.append(_mat_rows8(scene.planes.material, npl))
    nb = scene.boxes.count
    if nb:
        parts_g.append(
            pad(jnp.concatenate([scene.boxes.lo, scene.boxes.hi], axis=-1))
        )
        parts_m.append(_mat_rows8(scene.boxes.material, nb))
    nt = scene.triangles.count
    if nt:
        tr = scene.triangles
        e1 = tr.v1 - tr.v0
        e2 = tr.v2 - tr.v0
        n = jnp.cross(e1, e2)
        n_norm = jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1), 1e-20))
        n_unit = n / n_norm[:, None]
        parts_g.append(
            pad(
                jnp.concatenate(
                    [tr.v0, e1, e2, n_unit, n_norm[:, None]], axis=-1
                )
            )
        )
        parts_m.append(_mat_rows8(tr.material, nt))
    return (
        jnp.concatenate(parts_g, axis=0),
        jnp.concatenate(parts_m, axis=0),
    )


def _sfc32_next(a, b, c, ctr):
    t = a + b + ctr
    ctr = ctr + jnp.uint32(1)
    a = b ^ (b >> 9)
    b = c + (c << 3)
    c = ((c << 21) | (c >> 11)) + t
    return t, a, b, c, ctr


def _uniform(a, b, c, ctr):
    bits, a, b, c, ctr = _sfc32_next(a, b, c, ctr)
    # Same conversion as ops/rng.py:sfc32_float (bits >> 8 < 2^24: exact).
    u = (bits >> 8).astype(jnp.float32)
    return u * np.float32(1.0 / (1 << 24)), a, b, c, ctr


def _angles_to_quat(rx, ry, rz):
    cy, sy = jnp.cos(rz * 0.5), jnp.sin(rz * 0.5)
    cp, sp = jnp.cos(ry * 0.5), jnp.sin(ry * 0.5)
    cr, sr = jnp.cos(rx * 0.5), jnp.sin(rx * 0.5)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = sy * cp * sr + cy * sp * cr
    z = sy * cp * cr - cy * sp * sr
    return w, x, y, z


def _quat_rotate(qw, qx, qy, qz, vx, vy, vz):
    # v + 2*qw*(u x v) + 2*(u x (u x v))
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def _table_layout(num_prims: int, gcols: int):
    """Flat-table offsets: geometry rows first ([P, gcols]), then material
    rows ([P, 8]); the whole table padded to a power of two."""
    n = num_prims * (gcols + 8)
    return n, max(1, 1 << (n - 1).bit_length())


def _flat_table(scene: Scene):
    """The scene as one flat f32 table (see `_table_layout`), plus its
    geometry width.  Differentiable in every continuous scene leaf."""
    geom, mat = _scene_tables(scene)
    num_prims, gcols = geom.shape
    n, padded = _table_layout(num_prims, gcols)
    flat = jnp.concatenate(
        [geom.reshape(-1), mat.reshape(-1), jnp.zeros((padded - n,), jnp.float32)]
    )
    return flat, gcols


def _rows(flat, num_prims: int, gcols: int):
    """Split a flat table (a sequence of scalars) into P geometry rows of
    `gcols` and P material rows of 8 — the form the unrolled fold consumes,
    and a pytree of scalar leaves `jax.vjp` returns per-entry cotangents
    for (the backward kernel's scene-parameter gradients)."""
    base = num_prims * gcols
    geom = [list(flat[p * gcols:(p + 1) * gcols]) for p in range(num_prims)]
    mat = [list(flat[base + p * 8:base + (p + 1) * 8]) for p in range(num_prims)]
    return geom, mat


def _nearest_hit_fold(
    geom, mat, num_spheres, num_prims, ox, oy, oz, dx, dy, dz,
    num_boxes=0, num_triangles=0,
):
    """Unrolled nearest-hit over the scene tables (scalar rows from
    `_rows`).  All ray operands are lane vectors; returns a dict of hit
    fields.

    Kind dispatch is STATIC: primitive order is spheres ++ planes ++
    boxes ++ triangles with compile-time counts, so each unrolled row
    emits only its own kind's intersection math (no kind column, no
    runtime branching) — the kernel's answer to the reference's typeclass
    unroll (upstream src/Util.hs:156-158)."""
    num_planes = num_prims - num_spheres - num_boxes - num_triangles
    shape = ox.shape
    best_t = jnp.full(shape, INFINITE, jnp.float32)
    b_ax = jnp.zeros(shape, jnp.float32)  # sphere center | plane normal x
    b_ay = jnp.zeros(shape, jnp.float32)
    b_az = jnp.zeros(shape, jnp.float32)
    b_cr = jnp.zeros(shape, jnp.float32)
    b_cg = jnp.zeros(shape, jnp.float32)
    b_cb = jnp.zeros(shape, jnp.float32)
    b_il = jnp.zeros(shape, jnp.float32)
    b_pr = jnp.zeros(shape, jnp.float32)
    b_kd = jnp.zeros(shape, jnp.float32)
    b_sp = jnp.zeros(shape, jnp.float32)  # is_sphere

    for p in range(num_prims):
        g = geom[p]
        m = mat[p]
        if p < num_spheres:
            cx, cy, cz, rad = g[0], g[1], g[2], g[3]
            lx, ly, lz = cx - ox, cy - oy, cz - oz
            tca = lx * dx + ly * dy + lz * dz
            d2 = lx * lx + ly * ly + lz * lz - tca * tca
            r2 = rad * rad
            outside = d2 > r2
            # Double-where (same as ops/intersect.py:sphere_distances):
            # sqrt'(0) = inf would leak NaN into the backward sweep through
            # the masked branch; pin miss lanes to a safe argument.
            thc_arg = jnp.where(outside, 1.0, jnp.maximum(r2 - d2, 1e-12))
            thc = jnp.where(outside, 0.0, jnp.sqrt(thc_arg))
            t = tca - thc
            miss = (tca < 0.0) | outside | (t < 0.0)
            t = jnp.where(miss, INFINITE, t)
            ax_, ay_, az_, is_sphere = cx, cy, cz, 1.0
        elif p < num_spheres + num_planes:
            px, py, pz, nx, ny, nz = g[0], g[1], g[2], g[3], g[4], g[5]
            denom = dx * nx + dy * ny + dz * nz
            num = (px - ox) * nx + (py - oy) * ny + (pz - oz) * nz
            denom_safe = jnp.where(
                denom == 0.0, PLANE_DENOM_EPS * 0.5, denom
            )
            dist = num / denom_safe
            miss = (denom > PLANE_DENOM_EPS) | (dist < 0.0)
            t = jnp.where(miss, INFINITE, dist)
            ax_, ay_, az_, is_sphere = nx, ny, nz, 0.0
        elif p < num_spheres + num_planes + num_boxes:
            # Branchless slab method (ops/intersect.py:box_distances), with
            # the face normal computed in-fold (it depends on the hit
            # point; ops/intersect.py:box_normal semantics — dominant axis
            # of the centered, half-size-normalized offset, x wins ties).
            lox, loy, loz = g[0], g[1], g[2]
            hix, hiy, hiz = g[3], g[4], g[5]
            tiny = np.float32(1e-12)

            def slab(lo, hi, o, d):
                d_safe = jnp.where(
                    jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d
                )
                inv = 1.0 / d_safe
                t1 = (lo - o) * inv
                t2 = (hi - o) * inv
                return jnp.minimum(t1, t2), jnp.maximum(t1, t2)

            nx_lo, nx_hi = slab(lox, hix, ox, dx)
            ny_lo, ny_hi = slab(loy, hiy, oy, dy)
            nz_lo, nz_hi = slab(loz, hiz, oz, dz)
            t_near = jnp.maximum(nx_lo, jnp.maximum(ny_lo, nz_lo))
            t_far = jnp.minimum(nx_hi, jnp.minimum(ny_hi, nz_hi))
            miss = (t_near > t_far) | (t_near <= 0.0)
            t = jnp.where(miss, INFINITE, t_near)
            t_box = jnp.where(miss, 0.0, t_near)
            qx = (ox + dx * t_box - (lox + hix) * 0.5) / jnp.maximum(
                (hix - lox) * 0.5, 1e-12
            )
            qy = (oy + dy * t_box - (loy + hiy) * 0.5) / jnp.maximum(
                (hiy - loy) * 0.5, 1e-12
            )
            qz = (oz + dz * t_box - (loz + hiz) * 0.5) / jnp.maximum(
                (hiz - loz) * 0.5, 1e-12
            )
            aqx, aqy, aqz = jnp.abs(qx), jnp.abs(qy), jnp.abs(qz)
            takex = (aqx >= aqy) & (aqx >= aqz)
            takey = ~takex & (aqy >= aqz)
            ax_ = jnp.where(takex, jnp.sign(qx), 0.0)
            ay_ = jnp.where(takey, jnp.sign(qy), 0.0)
            az_ = jnp.where(takex | takey, 0.0, jnp.sign(qz))
            is_sphere = 0.0
        else:
            # Möller–Trumbore with precomputed edges and the plane's
            # one-sided convention (ops/intersect.py:triangle_distances).
            v0x, v0y, v0z = g[0], g[1], g[2]
            e1x, e1y, e1z = g[3], g[4], g[5]
            e2x, e2y, e2z = g[6], g[7], g[8]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            miss = (
                (det <= PLANE_DENOM_EPS * g[12])
                | (u < 0.0)
                | (v < 0.0)
                | (u + v > 1.0)
                | (t < 0.0)
            )
            t = jnp.where(miss, INFINITE, t)
            ax_, ay_, az_, is_sphere = g[9], g[10], g[11], 0.0

        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        b_ax = jnp.where(better, ax_, b_ax)
        b_ay = jnp.where(better, ay_, b_ay)
        b_az = jnp.where(better, az_, b_az)
        b_cr = jnp.where(better, m[0], b_cr)
        b_cg = jnp.where(better, m[1], b_cg)
        b_cb = jnp.where(better, m[2], b_cb)
        b_il = jnp.where(better, m[3], b_il)
        b_pr = jnp.where(better, m[4], b_pr)
        b_kd = jnp.where(better, m[5], b_kd)
        b_sp = jnp.where(better, is_sphere, b_sp)

    hit = best_t < INFINITE
    t_safe = jnp.where(hit, best_t, 0.0)
    hx, hy, hz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    # normal: sphere -> normalize(hitpoint - center); plane -> stored normal
    sx, sy_, sz = hx - b_ax, hy - b_ay, hz - b_az
    # 1/sqrt (not rsqrt) to match the XLA path's normalize_safe; the inner
    # where keeps the backward sweep finite on degenerate (all-miss,
    # origin-at-zero) lanes where the offset is exactly the zero vector.
    sq = sx * sx + sy_ * sy_ + sz * sz
    sq_ok = sq > 1e-20
    inv = jnp.where(
        sq_ok, 1.0 / jnp.sqrt(jnp.where(sq_ok, sq, 1.0)), 1e20
    )
    is_s = b_sp > 0.5
    nx = jnp.where(is_s, sx * inv, b_ax)
    ny = jnp.where(is_s, sy_ * inv, b_ay)
    nz = jnp.where(is_s, sz * inv, b_az)
    return dict(
        hit=hit, hx=hx, hy=hy, hz=hz, nx=nx, ny=ny, nz=nz,
        cr=b_cr, cg=b_cg, cb=b_cb, il=b_il, pr=b_pr, kd=b_kd,
    )


def _draw_vec(ra, rb, rc, rctr):
    """genVec (upstream src/Util.hs:114-118): three SFC32 uniforms
    mapped to [-1, 1], advancing the rng planes by exactly 3 draws."""
    ux, ra, rb, rc, rctr = _uniform(ra, rb, rc, rctr)
    uy, ra, rb, rc, rctr = _uniform(ra, rb, rc, rctr)
    uz, ra, rb, rc, rctr = _uniform(ra, rb, rc, rctr)
    return (
        ux * 2.0 - 1.0, uy * 2.0 - 1.0, uz * 2.0 - 1.0, ra, rb, rc, rctr
    )


def _brdf_sample_from_vec(h, dx, dy, dz, vx, vy, vz, has_dielectric=True):
    """calcNextRay (Trace.hs:394-435) on lane vectors: BRDF importance
    sampling from a pre-drawn random vector (vx, vy, vz in [-1, 1]), so
    the backward kernel can differentiate one bounce with the RNG
    detached.  Returns (next origin x3, next direction x3, throughput
    modifier x3).

    `has_dielectric=False` (a static, host-derived fact about the scene's
    material kinds) elides the glass block entirely — it consumes no RNG
    draws, so skipping it is bit-exact for dielectric-free scenes."""
    nx, ny, nz = h["nx"], h["ny"], h["nz"]
    p = h["pr"]

    # Matte
    pi = np.float32(np.pi)
    qw, qx, qy, qz = _angles_to_quat(pi * vx, pi * vy, pi * vz)
    mx, my, mz = _quat_rotate(qw, qx, qy, qz, nx, ny, nz)
    m_b = p / pi * (mx * nx + my * ny + mz * nz)

    # Glossy
    ia = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * ia * nx, dy - 2.0 * ia * ny, dz - 2.0 * ia * nz
    s = 1.0 - p
    qw2, qx2, qy2, qz2 = _angles_to_quat(s * vx, s * vy, s * vz)
    gx, gy, gz = _quat_rotate(qw2, qx2, qy2, qz2, rx, ry, rz)
    g_b = jnp.maximum(0.0, gx * rx + gy * ry + gz * rz)

    kd = h["kd"]
    is_g = kd == 1.0
    if not has_dielectric:
        ox2 = jnp.where(is_g, gx, mx)
        oy2 = jnp.where(is_g, gy, my)
        oz2 = jnp.where(is_g, gz, mz)
        b = jnp.where(is_g, g_b, m_b)
        scale = b * INV_TWO_PI
        no_x = h["hx"] + ox2 * EPSILON
        no_y = h["hy"] + oy2 * EPSILON
        no_z = h["hz"] + oz2 * EPSILON
        return (no_x, no_y, no_z, ox2, oy2, oz2,
                h["cr"] * scale, h["cg"] * scale, h["cb"] * scale)

    # Dielectric (glass), Fresnel choice via vx-derived uniform
    cos_i = -(dx * nx + dy * ny + dz * nz)
    inside = cos_i < 0.0
    fnx = jnp.where(inside, -nx, nx)
    fny = jnp.where(inside, -ny, ny)
    fnz = jnp.where(inside, -nz, nz)
    aci = jnp.abs(cos_i)
    ior = p
    eta = jnp.where(inside, ior, 1.0 / jnp.maximum(ior, 1e-6))
    sin2 = eta * eta * jnp.maximum(1.0 - aci * aci, 0.0)
    tir = sin2 > 1.0
    cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(1.0 - sin2, 1e-12))))
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fres = r0 + (1.0 - r0) * (1.0 - aci) ** 5
    refl_p = jnp.where(tir, 1.0, fres)
    u = (vx + 1.0) * 0.5
    take_refl = u < refl_p
    k = eta * aci - cos_t
    tx_ = eta * dx + k * fnx
    ty_ = eta * dy + k * fny
    tz_ = eta * dz + k * fnz
    tq = tx_ * tx_ + ty_ * ty_ + tz_ * tz_
    tq_ok = tq > 1e-20
    tinv = jnp.where(
        tq_ok, 1.0 / jnp.sqrt(jnp.where(tq_ok, tq, 1.0)), 1e20
    )
    ddx = jnp.where(take_refl, rx, tx_ * tinv)
    ddy = jnp.where(take_refl, ry, ty_ * tinv)
    ddz = jnp.where(take_refl, rz, tz_ * tinv)

    is_d = kd == 2.0
    ox2 = jnp.where(is_d, ddx, jnp.where(is_g, gx, mx))
    oy2 = jnp.where(is_d, ddy, jnp.where(is_g, gy, my))
    oz2 = jnp.where(is_d, ddz, jnp.where(is_g, gz, mz))
    b = jnp.where(is_d, 1.0, jnp.where(is_g, g_b, m_b))
    scale = jnp.where(is_d, b, b * INV_TWO_PI)

    no_x = h["hx"] + ox2 * EPSILON
    no_y = h["hy"] + oy2 * EPSILON
    no_z = h["hz"] + oz2 * EPSILON
    tm_r = h["cr"] * scale
    tm_g = h["cg"] * scale
    tm_b = h["cb"] * scale
    return (no_x, no_y, no_z, ox2, oy2, oz2, tm_r, tm_g, tm_b)


def _bounce_core(
    geom_rows, mat_rows, num_spheres, num_prims, has_dielectric,
    ox, oy, oz, dx, dy, dz, th_r, th_g, th_b, vx, vy, vz,
    num_boxes=0, num_triangles=0,
):
    """One bounce as a pure function of (scene tables, float state, random
    vector) — the differentiation unit of the backward megakernel.

    Returns (next origin x3, next direction x3, next throughput x3,
    emission contribution x3, dead mask).  Dead lanes (nearZero throughput
    or miss, Trace.hs:364-365) keep their ray, contribute zero emission and
    zero their throughput — identical semantics (and identical f32 op
    order) to the forward kernel's bounce, which is cross-checked bit-exact
    against the XLA integrator in tests/test_pallas.py.
    """
    h = _nearest_hit_fold(
        geom_rows, mat_rows, num_spheres, num_prims, ox, oy, oz, dx, dy, dz,
        num_boxes=num_boxes, num_triangles=num_triangles,
    )
    q = th_r * th_r + th_g * th_g + th_b * th_b
    dead = (q <= NEAR_ZERO_EPS) | ~h["hit"]

    (no_x, no_y, no_z, nd_x, nd_y, nd_z, tm_r, tm_g, tm_b) = (
        _brdf_sample_from_vec(h, dx, dy, dz, vx, vy, vz, has_dielectric)
    )
    em_r = jnp.where(dead, 0.0, h["cr"] * h["il"] * th_r)
    em_g = jnp.where(dead, 0.0, h["cg"] * h["il"] * th_g)
    em_b = jnp.where(dead, 0.0, h["cb"] * h["il"] * th_b)

    sel = lambda a_, b_: jnp.where(dead, a_, b_)
    return (
        sel(ox, no_x), sel(oy, no_y), sel(oz, no_z),
        sel(dx, nd_x), sel(dy, nd_y), sel(dz, nd_z),
        jnp.where(dead, 0.0, th_r * tm_r),
        jnp.where(dead, 0.0, th_g * tm_g),
        jnp.where(dead, 0.0, th_b * tm_b),
        em_r, em_g, em_b, dead,
    )


def _lanes(n: int, block: int):
    """This program's lane indices, the valid-lane mask, and the indices
    the lanes read: tail lanes past `n` re-read the last pixel, so they
    compute finite values that the masked store drops."""
    idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    return idx, idx < n, jnp.minimum(idx, n - 1)


def _megakernel_body(
    table_ref,
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
    ra_ref, rb_ref, rc_ref, rctr_ref,
    out_r_ref, out_g_ref, out_b_ref,
    out_ra_ref, out_rb_ref, out_rc_ref, out_rctr_ref,
    *, n, block, spp, num_bounces, num_spheres, num_prims, gcols,
    russian_roulette=False, rr_start=3, has_dielectric=True,
    num_boxes=0, num_triangles=0,
):
    idx, valid, src = _lanes(n, block)
    load = lambda r: plgpu.load(r.at[src])
    table_len = num_prims * (gcols + 8)
    geom, mat = _rows(
        [table_ref[k] for k in range(table_len)], num_prims, gcols
    )
    pox, poy, poz = load(ox_ref), load(oy_ref), load(oz_ref)
    pdx, pdy, pdz = load(dx_ref), load(dy_ref), load(dz_ref)
    ra, rb, rc, rctr = load(ra_ref), load(rb_ref), load(rc_ref), load(rctr_ref)

    zeros = jnp.zeros((block,), jnp.float32)
    ones = jnp.ones((block,), jnp.float32)

    def bounce(i, st):
        (ox, oy, oz, dx, dy, dz, ra, rb, rc, rctr,
         res_r, res_g, res_b, th_r, th_g, th_b) = st
        vx, vy, vz, ra2, rb2, rc2, rctr2 = _draw_vec(ra, rb, rc, rctr)
        (no_x, no_y, no_z, nd_x, nd_y, nd_z,
         nth_r, nth_g, nth_b, em_r, em_g, em_b, dead) = _bounce_core(
            geom, mat, num_spheres, num_prims, has_dielectric,
            ox, oy, oz, dx, dy, dz, th_r, th_g, th_b, vx, vy, vz,
            num_boxes=num_boxes, num_triangles=num_triangles,
        )
        if russian_roulette:
            u, ra2, rb2, rc2, rctr2 = _uniform(ra2, rb2, rc2, rctr2)
            p_surv = jnp.clip(
                jnp.maximum(nth_r, jnp.maximum(nth_g, nth_b)), 0.05, 1.0
            )
            active = jnp.asarray(i, jnp.int32) >= rr_start
            killed = active & (u >= p_surv)
            scale = jnp.where(active, 1.0 / p_surv, 1.0)
            # Dead lanes are already zeroed; 0 * scale stays 0.
            nth_r = jnp.where(killed, 0.0, nth_r * scale)
            nth_g = jnp.where(killed, 0.0, nth_g * scale)
            nth_b = jnp.where(killed, 0.0, nth_b * scale)

        sel = lambda a_, b_: jnp.where(dead, a_, b_)
        return (
            no_x, no_y, no_z, nd_x, nd_y, nd_z,
            sel(ra, ra2), sel(rb, rb2), sel(rc, rc2), sel(rctr, rctr2),
            res_r + em_r, res_g + em_g, res_b + em_b,
            nth_r, nth_g, nth_b,
        )

    def one_sample(_, carry):
        ra, rb, rc, rctr, acc_r, acc_g, acc_b = carry
        st = (pox, poy, poz, pdx, pdy, pdz, ra, rb, rc, rctr,
              zeros, zeros, zeros, ones, ones, ones)
        st = jax.lax.fori_loop(0, num_bounces, bounce, st)
        ra, rb, rc, rctr, res_r, res_g, res_b = st[6:13]
        return (ra, rb, rc, rctr,
                acc_r + res_r, acc_g + res_g, acc_b + res_b)

    carry = (ra, rb, rc, rctr, zeros, zeros, zeros)
    carry = jax.lax.fori_loop(0, spp, one_sample, carry)
    for ref, val in zip(
        (out_ra_ref, out_rb_ref, out_rc_ref, out_rctr_ref,
         out_r_ref, out_g_ref, out_b_ref),
        carry,
    ):
        plgpu.store(ref.at[idx], val, mask=valid)


def scene_has_dielectric(scene: Scene) -> bool:
    """Static (host-side) fact: does any material sample glass?  Under
    tracing the kinds are unknown, so the answer is conservatively True."""
    kinds = [
        part.material.brdf_kind
        for part in (scene.spheres, scene.planes, scene.boxes, scene.triangles)
        if part.count
    ]
    if any(isinstance(k, jax.core.Tracer) for k in kinds):
        return True
    return any(bool((np.asarray(k) == BRDF_DIELECTRIC).any()) for k in kinds)


def _planes(x):
    """[H, W, C] -> C flat [H*W] planes."""
    return [x[..., i].reshape(-1) for i in range(x.shape[-1])]


def _launch(body, n, inputs, out_shape, block, num_warps, interpret):
    return pl.pallas_call(
        body,
        grid=(pl.cdiv(n, block),),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
    )(*inputs)


def trace_tables(
    table, gcols, ray_o, ray_d, rng_state,
    *, spp, num_bounces, num_spheres, num_prims, has_dielectric,
    num_boxes=0, num_triangles=0, russian_roulette=False, rr_start=3,
    interpret=False,
):
    """The forward kernel at the flat-table level.  Returns (radiance sum
    [H, W, 3] over `spp` samples, final rng [H, W, 4])."""
    H, W = rng_state.shape[:2]
    n = H * W
    body = functools.partial(
        _megakernel_body,
        n=n, block=BLOCK, spp=spp, num_bounces=num_bounces,
        num_spheres=num_spheres, num_prims=num_prims, gcols=gcols,
        russian_roulette=russian_roulette, rr_start=rr_start,
        has_dielectric=has_dielectric,
        num_boxes=num_boxes, num_triangles=num_triangles,
    )
    out = _launch(
        body, n,
        [table] + _planes(ray_o) + _planes(ray_d) + _planes(rng_state),
        [jax.ShapeDtypeStruct((n,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((n,), jnp.uint32)] * 4,
        BLOCK, NUM_WARPS, interpret,
    )
    radiance = jnp.stack(out[0:3], axis=-1).reshape(H, W, 3)
    rng_out = jnp.stack(out[3:7], axis=-1).reshape(H, W, 4)
    return radiance, rng_out


def trace_inline_pallas(
    scene: Scene,
    rays,
    rng_state: jnp.ndarray,
    num_bounces: int = 15,
    spp: int = 1,
    russian_roulette: bool = False,
    rr_start: int = 3,
    interpret: bool = False,
    has_dielectric: bool | None = None,
):
    """Fused multi-sample inline trace.  Returns (radiance_sum [H,W,3] over
    `spp` samples, final rng [H,W,4]) — drop-in for `spp` iterations of
    `trace_inline` summed.  Any image shape works.

    `has_dielectric` statically gates the glass sampling block (it draws no
    RNG, so eliding it is bit-exact for glass-free scenes).  `None`
    derives it with `scene_has_dielectric`.
    """
    if has_dielectric is None:
        has_dielectric = scene_has_dielectric(scene)
    table, gcols = _flat_table(scene)
    return trace_tables(
        table, gcols, rays.origin, rays.direction, rng_state,
        spp=spp, num_bounces=num_bounces,
        num_spheres=scene.spheres.count, num_prims=scene.num_primitives,
        has_dielectric=has_dielectric,
        num_boxes=scene.boxes.count, num_triangles=scene.triangles.count,
        russian_roulette=russian_roulette, rr_start=rr_start,
        interpret=interpret,
    )
