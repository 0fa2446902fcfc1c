"""Vectorized ray-primitive intersection and nearest-hit resolution.

The JAX replacement for the reference's `Primitive` typeclass and
`checkHit` (upstream src/Scene/Intersection.hs:16-64,
upstream src/Scene/Trace.hs:443-447).  Where the reference unrolls a
Haskell list of 7 primitives at kernel-compile time
(upstream src/Util.hs:156-178), we intersect a ray batch against the
whole SoA primitive batch with one vectorized min-reduce — no unrolling, and
it scales to thousands of primitives (optionally chunked with `lax.scan` to
bound the [rays, prims] intermediate).

Accept/reject rules follow the reference exactly (the intersection property
tests in upstream test/Scene/Intersection/Tests.hs are the contract):

  * sphere (Intersection.hs:39-48, geometric/scratchapixel method): miss when
    `tca < 0` (center behind origin), `d2 > r^2` (ray passes outside), or
    `t = tca - thc < 0` (origin inside the sphere -> backface cull);
  * plane (Intersection.hs:57-62): one-sided — miss when `denom > 1e-6`
    (ray travels with the normal; only front faces hit) or `dist < 0`.

Misses encode as `t = INFINITE` = f32 max, matching `infinite`
(upstream src/Scene/Trace.hs:450-451).  Nearest-hit ties resolve to the
lowest primitive index, spheres before planes — the same winner as the
reference's left fold with `<=` (upstream src/Util.hs:171-178).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import linalg
from ..models.objects import Planes, Scene, Spheres

# `infinite` = encodeFloat 16777215 104 = (2^24-1) * 2^104 = f32 max
# (upstream src/Scene/Trace.hs:450-451).
INFINITE = np.float32(np.finfo(np.float32).max)

# Self-intersection offset (upstream src/Scene/Trace.hs:455-456).
EPSILON = np.float32(0.002)

PLANE_DENOM_EPS = np.float32(1e-6)


def sphere_distances(ray_o, ray_d, spheres: Spheres, reject_below=0.0):
    """Distances from rays [..., 3] to every sphere.  Returns [..., N] f32
    with misses = INFINITE.  Gradient-safe (no NaN from masked lanes).

    `reject_below` is the acceptance floor: 0 for camera rays, EPSILON
    when querying from a shade point (the physical/NEE family's
    shade-frame convention — accept `t >= eps` from the unshifted hit
    point, the same f32 sequence and accept set as the NEE oracles; the
    `tca` test is implied by `t >= eps` with `thc >= 0` but kept for
    clarity)."""
    # Broadcast rays [..., 1, 3] against spheres [N, 3].
    l = spheres.pos - ray_o[..., None, :]  # [..., N, 3]
    tca = linalg.dot(l, ray_d[..., None, :])  # [..., N]
    d2 = linalg.quadrance(l) - tca * tca
    r2 = spheres.radius * spheres.radius
    # Double-where: on miss lanes (d2 > r2) the clamp makes sqrt's argument
    # exactly 0 and sqrt'(0) = inf would leak NaN into the VJP through the
    # masked branch; pin those lanes to a safe argument and a 0 primal.
    outside = d2 > r2
    thc_arg = jnp.where(outside, 1.0, jnp.maximum(r2 - d2, 1e-12))
    thc = jnp.where(outside, 0.0, jnp.sqrt(thc_arg))
    t = tca - thc  # == min(tca-thc, tca+thc), Intersection.hs:46-48
    miss = (tca < reject_below) | outside | (t < reject_below)
    return jnp.where(miss, INFINITE, t)


def plane_distances(ray_o, ray_d, planes: Planes, reject_below=0.0):
    """Distances from rays [..., 3] to every one-sided plane. [..., M] f32."""
    denom = linalg.dot(ray_d[..., None, :], planes.normal)  # [..., M]
    num = linalg.dot(planes.pos - ray_o[..., None, :], planes.normal)
    # The reference divides by denom unguarded (Intersection.hs:62); we only
    # displace exact zeros (whose 0/0 would poison gradients) to a tiny value,
    # preserving the reference's "grazing rays can hit at huge distance"
    # behavior for every representable nonzero denom.
    denom_safe = jnp.where(denom == 0.0, PLANE_DENOM_EPS * 0.5, denom)
    dist = num / denom_safe
    miss = (denom > PLANE_DENOM_EPS) | (dist < reject_below)
    return jnp.where(miss, INFINITE, dist)


def box_distances(ray_o, ray_d, boxes, reject_below=0.0):
    """Distances from rays [..., 3] to every axis-aligned box. [..., N] f32.

    Branchless slab method.  One-sided with the sphere's convention
    (Intersection.hs:46-48 culls `t < 0`, i.e. origin-inside): only the
    *entry* face hits — a ray starting inside the box misses it.
    """
    o = ray_o[..., None, :]  # [..., 1, 3]
    d = ray_d[..., None, :]
    # Axis-parallel rays: displace zero components so the slab division
    # yields huge finite ts instead of 0 * inf = NaN.
    tiny = jnp.float32(1e-12)
    d_safe = jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / d_safe
    t1 = (boxes.lo - o) * inv  # [..., N, 3]
    t2 = (boxes.hi - o) * inv
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)  # [..., N]
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    miss = (t_near > t_far) | (t_near <= 0.0) | (t_near < reject_below)
    return jnp.where(miss, INFINITE, t_near)


def box_normal(point, lo, hi):
    """Outward normal of the box face containing `point` (the dominant
    axis of the centered, half-size-normalized hit offset)."""
    center = (lo + hi) * 0.5
    half = jnp.maximum((hi - lo) * 0.5, 1e-12)
    q = (point - center) / half
    axis = jnp.argmax(jnp.abs(q), axis=-1)
    return jax.nn.one_hot(axis, 3, dtype=point.dtype) * jnp.sign(
        jnp.take_along_axis(q, axis[..., None], axis=-1)
    )


def triangle_distances(ray_o, ray_d, tris, reject_below=0.0):
    """Distances from rays [..., 3] to every triangle. [..., N] f32.

    Möller–Trumbore, one-sided with the plane's convention
    (Intersection.hs:57): the front face is where the geometric normal
    `cross(v1-v0, v2-v0)` points; `det = -dot(d, n)`, so the plane's
    `denom > 1e-6 -> miss` rule becomes `det <= 1e-6 -> miss`.
    """
    e1 = tris.v1 - tris.v0  # [N, 3]
    e2 = tris.v2 - tris.v0
    d = ray_d[..., None, :]  # [..., 1, 3]
    pvec = jnp.cross(d, e2)  # [..., N, 3]
    det = linalg.dot(e1, pvec)  # [..., N]
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    tvec = ray_o[..., None, :] - tris.v0  # [..., N, 3]
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)  # [..., N, 3]
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    # The front-face test must match the plane's `dot(d, n_unit) < -1e-6`
    # rule: det = -dot(d, cross(e1, e2)) scales with twice the triangle's
    # area, so compare against eps * |cross(e1, e2)| — an absolute 1e-6
    # would silently cull every small triangle.
    n_norm = linalg.norm(jnp.cross(e1, e2))  # [N]
    miss = (
        (det <= PLANE_DENOM_EPS * n_norm)
        | (u < 0.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t < reject_below)
    )
    return jnp.where(miss, INFINITE, t)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record (the reference's
    `Maybe (NormalP, Material)` from `checkHit`, Trace.hs:443-447, flattened
    to SoA with an explicit mask).

    All fields have the ray batch's leading shape.
    """

    t: jnp.ndarray  # [...] f32, INFINITE on miss
    hit: jnp.ndarray  # [...] bool
    prim: jnp.ndarray  # [...] i32 index into spheres ++ planes
    point: jnp.ndarray  # [..., 3] hit position (o + d * t)
    normal: jnp.ndarray  # [..., 3] outward surface normal at hit
    color: jnp.ndarray  # [..., 3] material albedo
    illuminance: jnp.ndarray  # [...] material emission scale
    brdf_kind: jnp.ndarray  # [...] i32
    brdf_param: jnp.ndarray  # [...] f32


def _field_table(scene: Scene) -> jnp.ndarray:
    """Per-primitive payload table [P, 8 or 11]:
    aux(3) = sphere center | plane normal | box lo | triangle normal,
    [aux2(3) = box hi — column group present only when the scene has
    boxes], color(3), illuminance, brdf_param.  Gathered hit attributes
    come from a one-hot contraction against this table (see
    `nearest_hit`).  Primitive order: spheres ++ planes ++ boxes ++
    triangles (Scene contract)."""
    with_aux2 = bool(scene.boxes.count)

    def rows(aux, aux2, mat):
        cols = [aux]
        if with_aux2:
            cols.append(aux2 if aux2 is not None else jnp.zeros_like(aux))
        cols += [mat.color, mat.illuminance[:, None], mat.brdf_param[:, None]]
        return jnp.concatenate(cols, axis=-1)

    parts = [
        rows(scene.spheres.pos, None, scene.spheres.material),
        rows(scene.planes.normal, None, scene.planes.material),
    ]
    if scene.boxes.count:
        parts.append(
            rows(scene.boxes.lo, scene.boxes.hi, scene.boxes.material)
        )
    if scene.triangles.count:
        tr = scene.triangles
        tri_n = linalg.normalize_safe(
            jnp.cross(tr.v1 - tr.v0, tr.v2 - tr.v0)
        )
        parts.append(rows(tri_n, None, tr.material))
    return jnp.concatenate(parts, axis=0)


# Above this primitive count, resolve t/prim with a chunked scan and the
# payload with a row gather: the [rays, P] distance plane and the one-hot
# matmul otherwise materialize O(rays * P) — 8+ GB at 2M rays x 1k prims
# (a device-memory OOM at 1920x1088 with 1000 spheres).
CHUNKED_THRESHOLD = 128
CHUNK_SIZE = 128

# The reference's declared accel-structure TODO
# (the reference's src/Scene/Objects.hs:55-59) is open: a two-level
# Morton-cluster hierarchy with block-coherent bounding-sphere culling was
# built once and lost to this flat fold on 1000 uniformly scattered
# spheres (a cluster radius of ~11 in a 60-wide scene leaves nothing to
# cull).  On the GPU, per-ray BVH traversal is the classic answer; it has
# not been measured here (ROADMAP.md).


def _nearest_t_prim_small(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """Direct formulation: one [rays, P] plane + masked-iota min."""
    parts = [
        sphere_distances(ray_o, ray_d, scene.spheres, reject_below),
        plane_distances(ray_o, ray_d, scene.planes, reject_below),
    ]
    if scene.boxes.count:
        parts.append(box_distances(ray_o, ray_d, scene.boxes, reject_below))
    if scene.triangles.count:
        parts.append(
            triangle_distances(ray_o, ray_d, scene.triangles, reject_below)
        )
    all_t = jnp.concatenate(parts, axis=-1)  # [..., P]
    num_prims = all_t.shape[-1]
    t = jnp.min(all_t, axis=-1)
    iota = jnp.arange(num_prims, dtype=jnp.int32)
    prim = jnp.min(
        jnp.where(all_t == t[..., None], iota, num_prims), axis=-1
    ).astype(jnp.int32)
    prim = jnp.minimum(prim, num_prims - 1)
    return t, prim


def _nearest_t_prim_chunked(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """Large-scene nearest hit: a lax.scan over sphere chunks, each step a
    distance + min + masked-iota argmin reduction over one [rays, CHUNK]
    block, then the (few) non-sphere kinds merged in.  Strict `<` keeps the
    first-primitive tie-break across and within chunks (argmin returns
    the first minimum)."""
    from ..models.objects import Spheres

    n = scene.spheres.count
    pad = (-n) % CHUNK_SIZE
    # Padded entries are masked to INFINITE inside the body (explicit mask
    # rather than sentinel geometry: huge coordinates overflow the f32
    # quadrance into inf-inf = NaN and poison the min).
    pos = jnp.concatenate(
        [scene.spheres.pos, jnp.zeros((pad, 3), jnp.float32)]
    )
    radius = jnp.concatenate(
        [scene.spheres.radius, jnp.zeros((pad,), jnp.float32)]
    )
    n_chunks = (n + pad) // CHUNK_SIZE
    pos_c = pos.reshape(n_chunks, CHUNK_SIZE, 3)
    rad_c = radius.reshape(n_chunks, CHUNK_SIZE)

    shape = ray_o.shape[:-1]
    init = (
        jnp.full(shape, INFINITE, jnp.float32),
        jnp.zeros(shape, jnp.int32),
    )

    def body(carry, chunk):
        best_t, best_p = carry
        c_pos, c_rad, offset = chunk
        ts = sphere_distances(
            ray_o, ray_d, Spheres(pos=c_pos, radius=c_rad, material=None),
            reject_below,
        )  # [..., CHUNK]
        valid = offset + jnp.arange(CHUNK_SIZE, dtype=jnp.int32) < n
        ts = jnp.where(valid, ts, INFINITE)
        c_t = jnp.min(ts, axis=-1)
        iota = jnp.arange(CHUNK_SIZE, dtype=jnp.int32)
        c_arg = jnp.min(
            jnp.where(ts == c_t[..., None], iota, CHUNK_SIZE), axis=-1
        ).astype(jnp.int32)
        better = c_t < best_t
        return (
            jnp.where(better, c_t, best_t),
            jnp.where(better, offset + jnp.minimum(c_arg, CHUNK_SIZE - 1),
                      best_p),
        ), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * CHUNK_SIZE
    if n_chunks:
        (t, prim), _ = jax.lax.scan(body, init, (pos_c, rad_c, offsets))
    else:
        t, prim = init
    return _merge_non_sphere(ray_o, ray_d, scene, t, prim, reject_below)


def _merge_non_sphere(ray_o, ray_d, scene: Scene, t, prim, reject_below=0.0):
    """Merge the (few) non-sphere kinds into a sphere-only (t, prim) best,
    in index order so the first-primitive tie-break holds across kinds."""

    def merge(t, prim, dists, offset):
        k = dists.shape[-1]
        kt = jnp.min(dists, axis=-1)
        iota = jnp.arange(k, dtype=jnp.int32)
        karg = jnp.min(
            jnp.where(dists == kt[..., None], iota, k), axis=-1
        ).astype(jnp.int32)
        better = kt < t
        return (
            jnp.where(better, kt, t),
            jnp.where(better, offset + jnp.minimum(karg, k - 1), prim),
        )

    offset = scene.spheres.count
    if scene.planes.count:
        t, prim = merge(
            t, prim,
            plane_distances(ray_o, ray_d, scene.planes, reject_below),
            offset,
        )
    offset += scene.planes.count
    if scene.boxes.count:
        t, prim = merge(
            t, prim,
            box_distances(ray_o, ray_d, scene.boxes, reject_below),
            offset,
        )
    offset += scene.boxes.count
    if scene.triangles.count:
        t, prim = merge(
            t, prim,
            triangle_distances(ray_o, ray_d, scene.triangles, reject_below),
            offset,
        )
    return t, prim


def nearest_t_prim(ray_o, ray_d, scene: Scene, reject_below=0.0):
    """Nearest (t, prim) only — the fold half of `nearest_hit`, exposed
    for estimator bodies that carry (t, prim) across bounces and gather
    the payload at the top of the next bounce (the physical/NEE family's
    loop shape, render/nee.py)."""
    num_prims = scene.num_primitives
    if num_prims > CHUNKED_THRESHOLD:
        return _nearest_t_prim_chunked(ray_o, ray_d, scene, reject_below)
    return _nearest_t_prim_small(ray_o, ray_d, scene, reject_below)


def nearest_hit(ray_o, ray_d, scene: Scene, reject_below=0.0) -> Hit:
    """Resolve the nearest intersection of each ray with the scene.

    `checkHit` parity (Trace.hs:443-447): linear scan over all primitives,
    min by distance, first primitive wins ties (primitive order is spheres
    then planes, as in `mapScene`, Util.hs:156-158).

    `reject_below` is the acceptance floor (0 = camera rays; EPSILON =
    the physical/NEE family's shade-frame bounce queries).

    Small scenes: a plain min-reduce for t, a masked-iota min-reduce for
    the winning index, and ONE one-hot matmul against a packed field table
    for the payload.  Above CHUNKED_THRESHOLD primitives the [rays, P]
    intermediates no longer fit (O(rays * P) device memory), so t/prim
    come from a chunked `lax.scan` and the payload from a row gather.
    """
    num_prims = scene.num_primitives
    chunked = num_prims > CHUNKED_THRESHOLD
    if chunked:
        t, prim = _nearest_t_prim_chunked(ray_o, ray_d, scene, reject_below)
    else:
        t, prim = _nearest_t_prim_small(ray_o, ray_d, scene, reject_below)
    return hit_from_t_prim(ray_o, ray_d, t, prim, scene, use_gather=chunked)


def hit_from_t_prim(
    ray_o, ray_d, t, prim, scene: Scene, use_gather: bool = True
) -> Hit:
    """Assemble the full `Hit` payload (point, normal, material) from a
    resolved (t, prim) pair — the second half of `nearest_hit`, exposed so
    estimator bodies that carry (t, prim) across bounces (render/nee.py)
    share one payload-gather implementation.  `use_gather` selects the
    row-gather formulation (right for large scenes); False selects the
    one-hot matmul for small primitive counts."""
    num_prims = scene.num_primitives
    chunked = use_gather
    hit = t < INFINITE

    kind_parts = [
        scene.spheres.material.brdf_kind,
        scene.planes.material.brdf_kind,
    ]
    if scene.boxes.count:
        kind_parts.append(scene.boxes.material.brdf_kind)
    if scene.triangles.count:
        kind_parts.append(scene.triangles.material.brdf_kind)
    all_kinds = jnp.concatenate(kind_parts)
    if chunked:
        # ONE row gather for payload + kind: folding the kind column into
        # the field table makes it one gather instead of two.
        rows = jnp.concatenate(
            [_field_table(scene), all_kinds.astype(jnp.float32)[:, None]],
            axis=-1,
        )[prim]
        fields = rows[..., :-1]
        brdf_kind = jnp.round(rows[..., -1]).astype(jnp.int32)
    else:
        iota = jnp.arange(num_prims, dtype=jnp.int32)
        onehot = (prim[..., None] == iota).astype(jnp.float32)  # [..., P]
        # precision=HIGHEST: the default f32 matmul precision may round
        # the operands (TF32 on the GPU, bf16 passes elsewhere) — the
        # gathered payload must be the exact table row.
        fields = jax.numpy.matmul(
            onehot, _field_table(scene), precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [..., 11] — exact: one-hot rows select exact table rows
        brdf_kind = jnp.round(
            jnp.matmul(onehot, all_kinds.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)
        ).astype(jnp.int32)

    aux = fields[..., 0:3]
    # aux2 (box hi corner) exists only when the scene has boxes — the table
    # stays 8 columns wide (and the sphere+plane graph bit-identical to the
    # pre-extension formulation) otherwise.
    base = 6 if scene.boxes.count else 3
    aux2 = fields[..., 3:6] if scene.boxes.count else None
    color = fields[..., base : base + 3]
    illuminance = fields[..., base + 3]
    brdf_param = fields[..., base + 4]

    n_spheres = scene.spheres.count
    n_planes = scene.planes.count
    n_boxes = scene.boxes.count
    is_sphere = prim < n_spheres

    # Hit point: o + d * t (default `hit`, Intersection.hs:29-32).  Use a
    # zeroed t on miss lanes so downstream math stays finite.
    t_safe = jnp.where(hit, t, 0.0)
    point = ray_o + ray_d * t_safe[..., None]

    # Normals: sphere -> normalize(point - center) (Intersection.hs:50);
    # plane/triangle -> constant normal carried in `aux`
    # (Intersection.hs:64); box -> dominant axis of the hit offset (`aux` =
    # lo corner, `aux2` = hi corner).
    sphere_n = linalg.normalize_safe(point - aux)
    normal = jnp.where(is_sphere[..., None], sphere_n, aux)
    if n_boxes:
        is_box = (prim >= n_spheres + n_planes) & (
            prim < n_spheres + n_planes + n_boxes
        )
        normal = jnp.where(
            is_box[..., None], box_normal(point, aux, aux2), normal
        )

    return Hit(
        t=t,
        hit=hit,
        prim=prim,
        point=point,
        normal=normal,
        color=color,
        illuminance=illuminance,
        brdf_kind=brdf_kind,
        brdf_param=brdf_param,
    )


def sphere_occluded_any(point, l_dir, t_l, exclude_prim, spheres: Spheres):
    """Sqrt-free any-hit shadow test against every sphere: True where SOME
    sphere other than `exclude_prim` (global index space: spheres first)
    intersects the ray (point, l_dir) with t in [EPSILON, t_l).

    With a FIXED comparison distance there is no need for the sqrt —
        t >= eps  <=>  (tca - eps >= 0) & ((tca - eps)^2 >= h)
        t <  t_l  <=>  (tca - t_l < 0) | ((tca - t_l)^2 < h)
    where h = r^2 - d^2 is the (negated) discriminant.  The physical/NEE
    estimator and its oracles (parity/oracle_nee_np.py, the native
    runtime) share this exact f32 sequence, so they make identical
    occlusion decisions.
    """
    l = spheres.pos - point[..., None, :]  # [..., N, 3]
    ll = linalg.quadrance(l)
    tca = linalg.dot(l, l_dir[..., None, :])
    r2 = spheres.radius * spheres.radius
    h = r2 - (ll - tca * tca)
    a1 = tca - EPSILON
    a2 = tca - t_l[..., None]
    iota = jnp.arange(spheres.count, dtype=jnp.int32)
    occ = (
        (h >= 0.0)
        & (a1 >= 0.0)
        & (a1 * a1 >= h)
        & ((a2 < 0.0) | (a2 * a2 < h))
        & (iota != exclude_prim[..., None])
    )
    return jnp.any(occ, axis=-1)


def shadow_occluded(point, l_dir, t_l, exclude_prim, scene: Scene):
    """Any-occluder shadow test over the whole scene (the physical/NEE
    family's shade-frame convention): True where any primitive other than
    `exclude_prim` blocks the segment [EPSILON, t_l) from `point` along
    `l_dir`.  Spheres use the sqrt-free forms (`sphere_occluded_any`);
    planes/boxes/triangles use their distance functions with the same
    [EPSILON, t_l) window."""
    occ = jnp.zeros(point.shape[:-1], bool)
    if scene.spheres.count:
        occ = sphere_occluded_any(
            point, l_dir, t_l, exclude_prim, scene.spheres
        )
    if scene.planes.count:
        pd = plane_distances(point, l_dir, scene.planes)
        occ = occ | jnp.any(
            (pd >= EPSILON) & (pd < t_l[..., None]), axis=-1
        )
    if scene.boxes.count:
        bd = box_distances(point, l_dir, scene.boxes, EPSILON)
        occ = occ | jnp.any(bd < t_l[..., None], axis=-1)
    if scene.triangles.count:
        td = triangle_distances(point, l_dir, scene.triangles, EPSILON)
        tri_base = scene.spheres.count + scene.planes.count + scene.boxes.count
        iota = tri_base + jnp.arange(scene.triangles.count, dtype=jnp.int32)
        occ = occ | jnp.any(
            (td < t_l[..., None]) & (iota != exclude_prim[..., None]),
            axis=-1,
        )
    return occ
