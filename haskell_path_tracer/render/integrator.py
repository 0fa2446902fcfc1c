"""Integrators: the inline megakernel bounce loop.

The JAX equivalent of `render Inline` / `traceInline`
(upstream src/Scene/Trace.hs:193-200, 344-383): the whole bounce loop
runs inside one jitted program as a `lax.fori_loop` over a pixel-grid-shaped
SoA state — XLA fuses raygen, intersection, shading and RNG into a few
kernels per bounce, the analog of the reference's "everything fused into
one map" fast path (Trace.hs:127-134).  The fused Pallas megakernel
(ops/pallas_megakernel.py) keeps the whole loop in one kernel.

Loop-carried state per pixel: (ray, rng_state, result, throughput), exactly
the reference's `T3 (ray, seed) result throughput` (Trace.hs:346-349).  Per
iteration (Trace.hs:359-383):

  * dead lanes — `nearZero throughput || miss` — zero their throughput and
    idle; ray / rng / result are NOT advanced (the reference's dead rays burn
    lanes identically, Trace.hs:364-365);
  * live lanes: result += emittance * throughput; throughput *= brdf
    modifier; ray <- sampled bounce; rng advances by exactly 3 draws.

The head-recursive radiance sum is carried tail-recursively via the
cumulative throughput product, as the reference documents (Trace.hs:91-97).

Extension (the reference's declared TODO, Trace.hs:338-340): optional Russian
roulette termination — unbiased early termination via throughput-proportional
survival, consuming one extra RNG draw per bounce (off in parity mode).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import Accumulator, Camera, Rays, Scene
from ..ops import brdf as brdf_ops
from ..ops import rng as rng_ops
from ..ops import routes
from ..ops.intersect import nearest_hit

DEFAULT_BOUNCES = 15  # maxIterations / the Inline limit (Trace.hs:80-81, 200)


def trace_inline(
    scene: Scene,
    rays: Rays,
    rng_state: jnp.ndarray,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    rr_start: int = 3,
    differentiable: bool = False,
):
    """Trace one sample per ray to completion.

    Returns (radiance [..., 3], final rng_state).  `num_bounces` is a static
    trace-time constant, like the reference's `limit` argument
    (Trace.hs:344-350).

    With `differentiable=True` the bounce loop runs as a rematerialized
    `lax.scan` instead of `fori_loop` (which lowers to a non-reverse-
    differentiable while loop): each bounce is wrapped in `jax.checkpoint`,
    so the backward sweep recomputes per-bounce hit data instead of storing
    it — the standard memory/compute trade for differentiating the bounce
    recursion (SURVEY.md §7 "hard parts").  Forward numerics are identical.
    """

    def body(i, state):
        ray_o, ray_d, rng, result, throughput = state
        hit = nearest_hit(ray_o, ray_d, scene)
        dead = linalg.near_zero(throughput) | ~hit.hit

        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, ray_d, rng)
        new_result = result + brdf_ops.emittance(hit) * throughput
        new_throughput = throughput * tmod

        if russian_roulette:
            # Survival probability = max throughput channel (clamped); scale
            # surviving throughput by 1/p to stay unbiased.
            u, rng2 = rng_ops.sfc32_float(rng2)
            p_survive = jnp.clip(
                jnp.max(new_throughput, axis=-1), 0.05, 1.0
            )
            active = jnp.asarray(i, jnp.int32) >= rr_start
            killed = active & (u >= p_survive)
            scale = jnp.where(active, 1.0 / p_survive, 1.0)
            new_throughput = jnp.where(
                killed[..., None], 0.0, new_throughput * scale[..., None]
            )

        # Dead lanes: keep ray/rng/result, zero the throughput
        # (Trace.hs:364-365).
        d3 = dead[..., None]
        return (
            jnp.where(d3, ray_o, next_o),
            jnp.where(d3, ray_d, next_d),
            jnp.where(dead[..., None], rng, rng2),
            jnp.where(d3, result, new_result),
            jnp.where(d3, 0.0, new_throughput),
        )

    zeros = jnp.zeros_like(rays.origin)
    init = (
        rays.origin,
        rays.direction,
        rng_state,
        zeros,  # initialColor (Trace.hs:353)
        jnp.ones_like(rays.origin),  # initialThroughput (Trace.hs:354)
    )
    if differentiable:
        ckpt_body = jax.checkpoint(lambda state, i: (body(i, state), None))
        (_, _, rng_out, result, _), _ = jax.lax.scan(
            ckpt_body, init, jnp.arange(num_bounces)
        )
    else:
        _, _, rng_out, result, _ = jax.lax.fori_loop(0, num_bounces, body, init)
    return result, rng_out


def render_sample_inline(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset=0,
    full_height: int | None = None,
) -> Accumulator:
    """One progressive sample: trace every pixel once and fold into the
    accumulator — `render Inline` (Trace.hs:193-200): new + old color, keep
    the new rng state.

    `row_offset`/`full_height` support image-tile sharding: the accumulator
    may be one device's row block of a larger image (see parallel/shard.py).
    """
    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_inline(
        scene, rays, acc.rng, num_bounces, russian_roulette
    )
    return Accumulator(
        color=acc.color + radiance,
        rng=rng_out,
        iterations=acc.iterations + 1,
    )


def render_batch_inline(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset=0,
    full_height: int | None = None,
) -> Accumulator:
    """`spp` samples in one dispatch via an on-device sample loop — the
    device-side version of the reference's host-side batching
    (upstream app/Main.hs:204-211, 240-242), with zero host round
    trips between samples."""

    def body(_, a):
        return render_sample_inline(
            scene, camera, a, num_bounces, russian_roulette,
            row_offset, full_height,
        )

    return jax.lax.fori_loop(0, spp, body, acc)


def render_batch_pallas(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset=0,
    full_height: int | None = None,
    interpret: bool = False,
    has_dielectric: bool | None = None,
) -> Accumulator:
    """`spp` samples via the fused Pallas megakernel
    (ops/pallas_megakernel.py): each pixel's whole sample + bounce loop runs
    in registers, touching device memory once per dispatch instead of once
    per bounce.  Same semantics as `render_batch_inline` (cross-checked in
    tests/test_pallas.py); radiance can differ in rare lanes where
    transcendental ulps flip a discrete bounce decision.  All four
    primitive kinds fold in-kernel (static kind dispatch over the
    16-column geometry table).
    """
    from ..ops.pallas_megakernel import trace_inline_pallas

    height, width = acc.color.shape[:2]
    rays = primary_rays(camera, width, height, row_offset, full_height)
    radiance, rng_out = trace_inline_pallas(
        scene,
        rays,
        acc.rng,
        num_bounces=num_bounces,
        spp=spp,
        russian_roulette=russian_roulette,
        interpret=interpret,
        has_dielectric=has_dielectric,
    )
    return Accumulator(
        color=acc.color + radiance,
        rng=rng_out,
        iterations=acc.iterations + spp,
    )


def render_batch_auto(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = DEFAULT_BOUNCES,
    russian_roulette: bool = False,
    row_offset=0,
    full_height: int | None = None,
    has_dielectric: bool | None = None,
    kernel: str = "auto",
) -> Accumulator:
    """The inline estimator through the route `kernel` ("auto", "xla" or
    "pallas") resolves to on this platform (ops/routes.py): the Pallas
    megakernel where one is kept, the XLA loop otherwise.
    `has_dielectric` (static) elides the kernel's glass block for
    glass-free scenes."""
    if routes.use_kernel(kernel, "parity"):
        return render_batch_pallas(
            scene, camera, acc, spp, num_bounces, russian_roulette,
            row_offset, full_height, has_dielectric=has_dielectric,
        )
    return render_batch_inline(
        scene, camera, acc, spp, num_bounces, russian_roulette,
        row_offset, full_height,
    )


def make_accumulator(width: int, height: int, seed: int | None = None) -> Accumulator:
    """Fresh zeroed accumulator + host-seeded SFC32 states — `initialOutput`
    (upstream src/Util.hs:204-205)."""
    return Accumulator(
        color=jnp.zeros((height, width, 3), jnp.float32),
        rng=rng_ops.gen_seeds((height, width), seed=seed),
        iterations=jnp.zeros((), jnp.int32),
    )
