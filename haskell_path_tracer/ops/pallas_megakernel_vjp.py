"""Differentiable parity megakernel for the GPU: fused forward + backward.

The XLA differentiable integrator (`trace_inline(differentiable=True)`,
render/integrator.py) rematerializes each bounce under `jax.checkpoint`,
which sends the full per-pixel state through device memory once per bounce
in each direction.  This module is a `jax.custom_vjp` whose

  * **forward** is the forward megakernel (ops/pallas_megakernel.py) —
    callers that never differentiate pay nothing;
  * **backward** is a second Pallas (Triton route) kernel that re-runs each
    sample's bounce loop per lane, writing each bounce's input state (ray,
    throughput) and its 3 pre-drawn SFC32 uniforms to a residual scratch
    output (each lane reads back only what it wrote, so it stays in
    cache), then sweeps the bounces in reverse, pulling the radiance
    cotangent through one `jax.vjp` of the pure per-bounce function
    (`_bounce_core`) at a time.  Both bounce loops are rolled: the kernel
    holds one bounce and one bounce's vjp, which keeps its compile time
    independent of the bounce count.

Differentiation semantics match the XLA path (diff/grad.py docstring):
decisions (hit masks, nearest-prim winner, BRDF branch, RNG draws) are
detached — the random vector is a stored constant of the sweep — and
gradients flow through intersection distances, normals, BRDF weights,
throughput products and emission.  Cross-checked against `jax.grad` of the
XLA integrator and against finite differences in tests/test_pallas_vjp.py.

Gradient outputs: the flat scene table (mapped back to every continuous
scene leaf by the differentiable `_flat_table` packing) and the primary
rays (camera derivatives through `primary_rays`).  Programs run in
parallel in no order, so each program writes its block's partial table
cotangent to its own row of an [n_blocks, T] output and XLA sums the rows
after the call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .pallas_megakernel import (
    _bounce_core,
    _draw_vec,
    _flat_table,
    _lanes,
    _launch,
    _planes,
    _rows,
    _table_layout,
    scene_has_dielectric,
    trace_tables,
)

# The backward sweep's live set per lane is several times the forward
# kernel's, so its programs are narrower: one warp of 32 lanes was the
# fastest of the block/warp sweep on an H100 (PERF.md, "H100").
BWD_BLOCK = 32
BWD_NUM_WARPS = 1
# Residual planes per bounce: origin, direction, throughput (9 floats) and
# the bounce's 3 pre-drawn uniforms.
_RES = 12


def _bwd_kernel(
    table_ref,
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
    ra_ref, rb_ref, rc_ref, rctr_ref,
    gr_ref, gg_ref, gb_ref,
    dtable_ref,
    dox_ref, doy_ref, doz_ref, ddx_ref, ddy_ref, ddz_ref,
    res_ref,
    *, n, block, spp, num_bounces, num_spheres, num_prims, gcols,
    has_dielectric, num_boxes=0, num_triangles=0,
):
    idx, valid, src = _lanes(n, block)
    load = lambda r: plgpu.load(r.at[src])
    _, table_len = _table_layout(num_prims, gcols)
    flat = tuple(table_ref[k] for k in range(table_len))
    rows_g, rows_m = _rows(flat, num_prims, gcols)

    pox, poy, poz = load(ox_ref), load(oy_ref), load(oz_ref)
    pdx, pdy, pdz = load(dx_ref), load(dy_ref), load(dz_ref)
    # Tail lanes duplicate the last pixel (finite values everywhere) and
    # carry a zero cotangent, so they add exactly nothing to the sums.
    g_r, g_g, g_b = (
        jnp.where(valid, load(r), 0.0) for r in (gr_ref, gg_ref, gb_ref)
    )
    zeros = jnp.zeros((block,), jnp.float32)
    ones = jnp.ones((block,), jnp.float32)

    def bounce_flat(flat_s, ox, oy, oz, dxx, dyy, dzz, thr, thg, thb,
                    vx, vy, vz):
        """The differentiation unit: one bounce as a function of the flat
        scalar table + float state, with the random vector closed over as
        a constant by the caller.  Returns the 12 float outputs (next
        origin/direction/throughput + emission); the dead mask (bool) is
        dropped — booleans carry no cotangent."""
        rg, rm = _rows(flat_s, num_prims, gcols)
        out = _bounce_core(
            rg, rm, num_spheres, num_prims, has_dielectric,
            ox, oy, oz, dxx, dyy, dzz, thr, thg, thb, vx, vy, vz,
            num_boxes=num_boxes, num_triangles=num_triangles,
        )
        return out[:12]

    def one_sample(_, carry):
        (ra, rb, rc, rctr, d_flat,
         adox, adoy, adoz, addx, addy, addz) = carry

        # ---- forward replay, writing each bounce's residuals ----
        def replay(b, st):
            (ox, oy, oz, dxx, dyy, dzz, thr, thg, thb,
             ra, rb, rc, rctr) = st
            vx, vy, vz, ra2, rb2, rc2, rctr2 = _draw_vec(ra, rb, rc, rctr)
            for c, v in enumerate((ox, oy, oz, dxx, dyy, dzz, thr, thg, thb,
                                   vx, vy, vz)):
                plgpu.store(res_ref.at[b * _RES + c, idx], v)
            (ox, oy, oz, dxx, dyy, dzz, thr, thg, thb,
             _, _, _, dead) = _bounce_core(
                rows_g, rows_m, num_spheres, num_prims, has_dielectric,
                ox, oy, oz, dxx, dyy, dzz, thr, thg, thb, vx, vy, vz,
                num_boxes=num_boxes, num_triangles=num_triangles,
            )
            # Dead lanes never advance their generator (Trace.hs:364-365).
            sel = lambda old, new: jnp.where(dead, old, new)
            return (ox, oy, oz, dxx, dyy, dzz, thr, thg, thb,
                    sel(ra, ra2), sel(rb, rb2), sel(rc, rc2),
                    sel(rctr, rctr2))

        st = jax.lax.fori_loop(
            0, num_bounces, replay,
            (pox, poy, poz, pdx, pdy, pdz, ones, ones, ones,
             ra, rb, rc, rctr),
        )
        ra, rb, rc, rctr = st[9:]

        # ---- reverse sweep ----
        # After the last bounce the ray and throughput are unused, so their
        # cotangents start at zero; the emission cotangent is the incoming
        # radiance cotangent at EVERY bounce (radiance = sum of emissions).
        def sweep(i, c):
            cts, d_flat = c
            b = num_bounces - 1 - i
            res = [plgpu.load(res_ref.at[b * _RES + k, idx])
                   for k in range(_RES)]
            _, vjp_fn = jax.vjp(
                lambda fl, *st: bounce_flat(fl, *st, *res[9:]),
                flat, *res[:9],
            )
            dflat_b, *d_state = vjp_fn(tuple(cts) + (g_r, g_g, g_b))
            return (tuple(d_state),
                    tuple(a + bb for a, bb in zip(d_flat, dflat_b)))

        cts, d_flat = jax.lax.fori_loop(
            0, num_bounces, sweep, ((zeros,) * 9, d_flat)
        )
        return (
            ra, rb, rc, rctr, d_flat,
            adox + cts[0], adoy + cts[1], adoz + cts[2],
            addx + cts[3], addy + cts[4], addz + cts[5],
        )

    d_flat0 = tuple(jnp.zeros((), jnp.float32) for _ in range(table_len))
    carry0 = (
        load(ra_ref), load(rb_ref), load(rc_ref), load(rctr_ref),
        d_flat0, zeros, zeros, zeros, zeros, zeros, zeros,
    )
    carry = jax.lax.fori_loop(0, spp, one_sample, carry0)
    d_flat = carry[4]
    for ref, val in zip(
        (dox_ref, doy_ref, doz_ref, ddx_ref, ddy_ref, ddz_ref), carry[5:]
    ):
        plgpu.store(ref.at[idx], val, mask=valid)
    # This program's partial table cotangent: its own row, summed by XLA.
    pid = pl.program_id(0)
    for k in range(table_len):
        dtable_ref[pid, k] = d_flat[k]


def _bwd_call(
    table, gcols, ray_o, ray_d, rng_state, g_rad,
    *, spp, num_bounces, num_spheres, num_prims, has_dielectric,
    num_boxes, num_triangles, interpret,
):
    """The backward kernel.  Returns the table cotangent of each program,
    [n_blocks, T] (program k covers flat pixels [k * BWD_BLOCK, (k + 1) *
    BWD_BLOCK)), and the per-pixel primary-ray cotangents [H, W, 3] x 2."""
    H, W = rng_state.shape[:2]
    n = H * W
    n_blocks = -(-n // BWD_BLOCK)
    n_pad = n_blocks * BWD_BLOCK
    body = functools.partial(
        _bwd_kernel,
        n=n, block=BWD_BLOCK, spp=spp, num_bounces=num_bounces,
        num_spheres=num_spheres, num_prims=num_prims, gcols=gcols,
        has_dielectric=has_dielectric,
        num_boxes=num_boxes, num_triangles=num_triangles,
    )
    out = _launch(
        body, n,
        [table] + _planes(ray_o) + _planes(ray_d) + _planes(rng_state)
        + _planes(g_rad),
        [jax.ShapeDtypeStruct((n_blocks, table.shape[0]), jnp.float32)]
        + [jax.ShapeDtypeStruct((n,), jnp.float32)] * 6
        # Residual scratch in device memory, one plane per (bounce, value),
        # indexed by lane: written by the replay, read back by the sweep.
        + [jax.ShapeDtypeStruct((num_bounces * _RES, n_pad), jnp.float32)],
        BWD_BLOCK, BWD_NUM_WARPS, interpret,
    )
    d_ray_o = jnp.stack(out[1:4], axis=-1).reshape(H, W, 3)
    d_ray_d = jnp.stack(out[4:7], axis=-1).reshape(H, W, 3)
    return out[0], d_ray_o, d_ray_d


@functools.lru_cache(maxsize=64)
def _make_diff_fn(
    gcols, spp, num_bounces, num_spheres, num_prims, has_dielectric,
    num_boxes, num_triangles, interpret,
):
    """Build (and cache) the custom-VJP trace for one static config."""
    static = dict(
        spp=spp, num_bounces=num_bounces, num_spheres=num_spheres,
        num_prims=num_prims, has_dielectric=has_dielectric,
        num_boxes=num_boxes, num_triangles=num_triangles,
        interpret=interpret,
    )

    @jax.custom_vjp
    def f(table, ray_o, ray_d, rng_state):
        return trace_tables(table, gcols, ray_o, ray_d, rng_state, **static)

    def fwd(table, ray_o, ray_d, rng_state):
        return f(table, ray_o, ray_d, rng_state), (
            table, ray_o, ray_d, rng_state,
        )

    def bwd(res, cts):
        table, ray_o, ray_d, rng_state = res
        g_rad, _g_rng = cts  # rng_out is integer: float0 cotangent, unused
        d_blocks, d_ray_o, d_ray_d = _bwd_call(
            table, gcols, ray_o, ray_d, rng_state, g_rad, **static,
        )
        d_rng = np.zeros(rng_state.shape, jax.dtypes.float0)
        return jnp.sum(d_blocks, axis=0), d_ray_o, d_ray_d, d_rng

    f.defvjp(fwd, bwd)
    return f


def trace_inline_pallas_diff(
    scene,
    rays,
    rng_state: jnp.ndarray,
    num_bounces: int = 4,
    spp: int = 1,
    interpret: bool = False,
    has_dielectric: bool | None = None,
):
    """Differentiable fused trace: (radiance_sum [H,W,3], rng_out [H,W,4]),
    with gradients w.r.t. every differentiable Scene leaf (via the
    `_flat_table` packing — incl. box corners and triangle vertices,
    whose table rows are differentiable functions of the vertices) and
    the primary rays.

    The RNG state is a detached constant of the gradient, exactly as in
    diff/grad.py."""
    if has_dielectric is None:
        has_dielectric = scene_has_dielectric(scene)
    table, gcols = _flat_table(scene)
    f = _make_diff_fn(
        gcols, spp, num_bounces, scene.spheres.count, scene.num_primitives,
        bool(has_dielectric), scene.boxes.count, scene.triangles.count,
        interpret,
    )
    return f(table, rays.origin, rays.direction, rng_state)
