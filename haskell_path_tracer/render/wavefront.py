"""Wavefront integrator: fixed-capacity ray queues.

Array-native redesign of the reference's `Streams` algorithm
(upstream src/Scene/Trace.hs:141-191, 272-331).  The reference leans
on Accelerate's `expand` — a dynamic-shape flat-map — for ray
expansion/compaction, which is exactly what broke its GPU backend
(Trace.hs:280-283) and what XLA's static-shape model forbids.  Here the
dynamic ray population lives in a *fixed-capacity queue*:

  * the ray-state SoA (`origin, direction, pixel, throughput, accum, rng`)
    occupies Q slots; a live count replaces dynamic shapes, and ray
    splitting expands through per-lane DFS stacks
    (`render_sample_wavefront_split`) rather than queue growth.  (A
    stream-compaction pass keeping live lanes front-dense — the literal
    `expand` counterpart — was built, user-wired and priced: the
    multi-operand-sort permutation lost to plain whole-queue processing at
    every reachable config, so it was deleted; see PERF.md.);
  * the device-resident bounce loop is `lax.while_loop`, the analog of the
    reference's `awhile` (Trace.hs:142-150), terminating when the live
    count hits zero or the bounce cap is reached;
  * **radiance accumulates per-lane** (`accum`), and is scatter-added into
    the image ONCE per sample after the loop.  The reference scatters
    every bounce (`permute`, Trace.hs:179-184) and that is where its GPU
    run died; per-bounce arbitrary-index scatters serialize on
    conflicting writes and cost a full queue pass each bounce.  The final
    scatter is a deterministic `segment-sum-by-pixel`, fixing the reference's seed-collision race
    (Trace.hs:186-191);
  * RNG states write back once at the end: dead lanes never advance their
    generator, so the final per-lane state IS the death-time state the
    reference's semantics require.

Termination matches `Inline` exactly (dead = miss or nearZero throughput,
checked before emission with the *previous* bounce's throughput), so
`wavefront == inline` bit-for-bit on split-free scenes — the cross-check
the reference could never make.  (Caveat: under XLA's
`--xla_allow_excess_precision` the two programs may fuse different FMA
contractions at some shapes; measured effect is ~1 boundary-decision
flip per 3e4 lanes at 256x128 — allclose, not bit-equal, there.)  Ray splitting (dielectrics) enqueues
child rays into the queue's spare capacity; see
`render_sample_wavefront_split`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import linalg
from ..models.camera import primary_rays
from ..models.objects import BRDF_DIELECTRIC, Accumulator, Camera, Scene
from ..ops import brdf as brdf_ops
from ..ops import rng as rng_ops
from ..ops.intersect import EPSILON, nearest_hit


class _QueueState(NamedTuple):
    bounce: jnp.ndarray  # [] i32
    count: jnp.ndarray  # [] i32 — live rays at the queue front
    ray_o: jnp.ndarray  # [Q, 3]
    ray_d: jnp.ndarray  # [Q, 3]
    pixel: jnp.ndarray  # [Q] i32 flat pixel id
    throughput: jnp.ndarray  # [Q, 3]
    accum: jnp.ndarray  # [Q, 3] per-lane radiance (scattered once at end)
    rng: jnp.ndarray  # [Q, 4] u32
    occupancy: jnp.ndarray  # [num_bounces + 1] i32 — rays entering each bounce


class WavefrontStats(NamedTuple):
    """Per-wavefront-step telemetry (SURVEY.md §5 observability plan).

    ``occupancy[b]`` is the number of rays entering bounce ``b`` — the live
    population the wavefront processed at that step (``occupancy[0]`` is
    the primary-ray count; the final entry is the population still alive
    after the last bounce).  Bounces never reached because the queue
    drained early report 0.  ``capacity`` is the queue size, so
    ``occupancy / capacity`` is lane utilization — the number that tells
    you when compaction or a smaller queue would pay off.
    """

    occupancy: jnp.ndarray  # [num_bounces + 1] i32
    capacity: int


def depth_histogram(stats: WavefrontStats) -> jnp.ndarray:
    """Bounce-depth histogram derived from occupancy.

    Entry ``b`` counts rays whose path performed exactly ``b`` shading
    events: a ray that dies (misses or hits near-zero throughput) during
    bounce ``b`` shaded only bounces ``0..b-1``, so deaths during bounce
    ``b`` = ``occupancy[b] - occupancy[b+1]`` have depth ``b``.  The final
    entry counts rays still alive at the bounce cap.  Length
    ``num_bounces + 1``; sums to the primary-ray count ``occupancy[0]``.
    """
    occ = stats.occupancy
    return jnp.concatenate([occ[:-1] - occ[1:], occ[-1:]])


def render_sample_wavefront(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    rr_start: int = 3,
    return_stats: bool = False,
    row_offset=0,
    full_height: int | None = None,
):
    """One progressive sample via the wavefront queue.

    Lanes keep pixel order and the whole queue is processed every bounce
    (the loop still drains early when the population hits zero).  A
    stream-compacted variant (live-dense invariant + a tile-skipping
    queue-front consumer) was built, wired to `--compact`, and priced
    slower than whole-queue processing even at its MOST favorable regime
    (512x512, 15 bounces, Russian roulette) — the compaction permutation (multi-operand sort + lane movement) costs
    more than the skipped intersect/shade work at every reachable
    config, so the path was deleted (PERF.md "Wavefront compaction").
    The answer to collapsing occupancy is a megakernel with path
    regeneration, which reuses dying lanes in registers instead of moving
    live ones through device memory (ROADMAP.md).

    `return_stats=True` additionally returns :class:`WavefrontStats` with
    per-bounce live-ray occupancy.
    """
    height, width = acc.color.shape[:2]
    num_pixels = height * width

    rays = primary_rays(camera, width, height, row_offset, full_height)
    state = _QueueState(
        bounce=jnp.zeros((), jnp.int32),
        count=jnp.asarray(num_pixels, jnp.int32),
        ray_o=rays.origin.reshape(num_pixels, 3),
        ray_d=rays.direction.reshape(num_pixels, 3),
        pixel=jnp.arange(num_pixels, dtype=jnp.int32),
        throughput=jnp.ones((num_pixels, 3), jnp.float32),
        accum=jnp.zeros((num_pixels, 3), jnp.float32),
        rng=acc.rng.reshape(num_pixels, 4),
        occupancy=jnp.zeros((num_bounces + 1,), jnp.int32),
    )

    def cond(s: _QueueState):
        return (s.bounce < num_bounces) & (s.count > 0)

    def shade_slab(bounce, ray_o, ray_d, throughput, accum, rng):
        """One bounce of intersect + shade over a slab of lanes.  Returns
        the updated slab state + per-lane alive mask.  Death test uses
        the stored (previous-bounce) throughput, before emission —
        Inline semantics (Trace.hs:364-365); a lane whose throughput is
        zero is dead forever, so `live` needs no separate flag."""
        hit = nearest_hit(ray_o, ray_d, scene)
        alive = hit.hit & ~linalg.near_zero(throughput)

        contrib = brdf_ops.emittance(hit) * throughput
        new_accum = jnp.where(alive[..., None], accum + contrib, accum)

        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, ray_d, rng)
        new_thpt = throughput * tmod

        if russian_roulette:
            u, rng2 = rng_ops.sfc32_float(rng2)
            p_survive = jnp.clip(jnp.max(new_thpt, axis=-1), 0.05, 1.0)
            active = bounce >= rr_start
            killed = active & (u >= p_survive)
            scale = jnp.where(active, 1.0 / p_survive, 1.0)
            new_thpt = jnp.where(
                killed[..., None], 0.0, new_thpt * scale[..., None]
            )

        a3 = alive[..., None]
        return (
            jnp.where(a3, next_o, ray_o),
            jnp.where(a3, next_d, ray_d),
            jnp.where(a3, new_thpt, jnp.zeros_like(throughput)),
            new_accum,
            jnp.where(alive[..., None], rng2, rng),
            alive,
        )

    def body(s: _QueueState) -> _QueueState:
        occupancy = s.occupancy.at[s.bounce].set(s.count)
        o2, d2, t2, a2, r2, alive = shade_slab(
            s.bounce, s.ray_o, s.ray_d, s.throughput, s.accum, s.rng
        )
        return s._replace(
            bounce=s.bounce + 1,
            count=jnp.sum(alive).astype(jnp.int32),
            ray_o=o2,
            ray_d=d2,
            throughput=t2,
            accum=a2,
            rng=r2,
            occupancy=occupancy,
        )

    final = jax.lax.while_loop(cond, body, state)

    # One deterministic scatter per sample: per-lane radiance sums into the
    # image, per-lane RNG states write back (each pixel owns exactly one
    # lane; dead lanes stopped advancing at death, so this IS the
    # death-time state).
    color = (
        acc.color.reshape(num_pixels, 3)
        .at[final.pixel]
        .add(final.accum, mode="drop")
    )
    rng_out = (
        acc.rng.reshape(num_pixels, 4)
        .at[final.pixel]
        .set(final.rng, mode="drop")
    )
    out = Accumulator(
        color=color.reshape(height, width, 3),
        rng=rng_out.reshape(height, width, 4),
        iterations=acc.iterations + 1,
    )
    if return_stats:
        # The slot for the bounce the loop stopped at was never written by
        # the body: record the population that carried out of the loop
        # (0 on early drain; cap survivors on a full run).
        occ = final.occupancy.at[final.bounce].set(final.count)
        return out, WavefrontStats(occupancy=occ, capacity=num_pixels)
    return out


def render_sample_wavefront_split(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    num_bounces: int = 15,
    queue_factor: float = 2.0,
    return_stats: bool = False,
    row_offset=0,
    full_height: int | None = None,
):
    """One progressive sample with *deterministic dielectric ray splitting*.

    At a glass hit the ray splits into both Fresnel branches — reflection
    continues immediately with weight F, refraction (weight 1-F) is pushed
    onto the lane's private stack and traced after the reflection subtree
    finishes.  This removes all branch-choice variance at dielectrics;
    expectation is identical to the stochastic one-branch estimator used by
    the inline integrator (tests/test_split.py).

    Array-native design (the `expand` the reference stubbed,
    upstream src/Scene/Trace.hs:116-118, 326-328): each pixel's lane
    performs a *depth-first traversal of its own split tree* using a
    fixed-depth per-lane stack.  A path pushes at most one child per depth
    level, and entries always carry strictly increasing depths, so
    ``num_bounces - 1`` slots bound the stack exactly — no overflow, no
    dropped children.  Stack access is a one-hot select over that small
    static axis, so the whole integrator is ELEMENTWISE: zero sorts, zero
    arbitrary-index scatters per bounce.  Both alternatives were built and
    rejected at 512x512/8b: per-bounce sort-compaction (the multi-operand
    `lax.sort`) and a bump-allocated arena scatter both pay a per-bounce
    permutation of the whole queue, while this formulation has no
    per-bounce queue maintenance at all.

    ``queue_factor`` sizes the per-lane stack: ``round(queue_factor)``
    pending children per lane (children pushed past that are dropped —
    they only remove energy), and the traversal loop is capped at
    ``num_bounces * (1 + slots)`` steps (it exits early when every lane
    drains).  The default (2 slots) loses nothing until a single path
    holds three unfinished glass subtrees at once; raise it for deep
    nested-glass scenes, at proportional stack-traffic cost.

    Lane i is pixel i forever, so radiance accumulates per lane and RNG
    write-back is positional — on split-free scenes this integrator is
    bit-for-bit identical (radiance AND RNG) to the plain wavefront.
    Child paths consume fresh draws from their lane's single SFC32 stream
    (sequential tree traversal — no shared or correlated draws).
    """
    height, width = acc.color.shape[:2]
    num_pixels = height * width
    # num_bounces - 1 slots would be lossless (one push per depth level,
    # strictly increasing depths); queue_factor trades stack traffic for
    # rare drops exactly like the reference-era queue capacity did.
    stack_depth = max(1, min(num_bounces - 1, int(round(queue_factor))))
    max_steps = num_bounces * (1 + stack_depth)

    rays = primary_rays(camera, width, height, row_offset, full_height)

    class _S(NamedTuple):
        step: jnp.ndarray  # [] i32 traversal step
        count: jnp.ndarray  # [] i32 lanes processing a segment
        ray_o: jnp.ndarray  # [P, 3]
        ray_d: jnp.ndarray  # [P, 3]
        depth: jnp.ndarray  # [P] i32 bounce depth of the current segment
        throughput: jnp.ndarray  # [P, 3]
        accum: jnp.ndarray  # [P, 3] per-lane radiance
        rng: jnp.ndarray  # [P, 4]
        live: jnp.ndarray  # [P] bool
        sp: jnp.ndarray  # [P] i32 stack size
        stk_o: jnp.ndarray  # [S, P, 3]
        stk_d: jnp.ndarray  # [S, P, 3]
        stk_t: jnp.ndarray  # [S, P, 3]
        stk_depth: jnp.ndarray  # [S, P] i32
        occupancy: jnp.ndarray  # [num_bounces + 1] i32 segments per depth

    state = _S(
        step=jnp.zeros((), jnp.int32),
        count=jnp.asarray(num_pixels, jnp.int32),
        ray_o=rays.origin.reshape(num_pixels, 3),
        ray_d=rays.direction.reshape(num_pixels, 3),
        depth=jnp.zeros((num_pixels,), jnp.int32),
        throughput=jnp.ones((num_pixels, 3), jnp.float32),
        accum=jnp.zeros((num_pixels, 3), jnp.float32),
        rng=acc.rng.reshape(num_pixels, 4),
        live=jnp.ones((num_pixels,), bool),
        sp=jnp.zeros((num_pixels,), jnp.int32),
        stk_o=jnp.zeros((stack_depth, num_pixels, 3), jnp.float32),
        stk_d=jnp.zeros((stack_depth, num_pixels, 3), jnp.float32),
        stk_t=jnp.zeros((stack_depth, num_pixels, 3), jnp.float32),
        stk_depth=jnp.zeros((stack_depth, num_pixels), jnp.int32),
        occupancy=jnp.zeros((num_bounces + 1,), jnp.int32),
    )

    def cond(s):
        return (s.step < max_steps) & (s.count > 0)

    def body(s):
        hit = nearest_hit(s.ray_o, s.ray_d, scene)
        # Same death rule as every other integrator (miss / nearZero
        # throughput, checked against the stored previous-segment
        # throughput) plus the per-lane bounce budget.
        alive = (
            s.live
            & hit.hit
            & ~linalg.near_zero(s.throughput)
            & (s.depth < num_bounces)
        )
        a3 = alive[..., None]

        # Per-depth segment telemetry (one one-hot accumulate; depth is
        # already < num_bounces wherever alive).  Only materialized when
        # the caller asked for stats — the [B+1, P] intermediate is pure
        # overhead otherwise.
        if return_stats:
            occ_idx = jnp.arange(num_bounces + 1, dtype=jnp.int32)
            occupancy = s.occupancy + jnp.sum(
                (s.depth[None, :] == occ_idx[:, None]) & alive[None, :],
                axis=1,
                dtype=jnp.int32,
            )
        else:
            occupancy = s.occupancy

        contrib = brdf_ops.emittance(hit) * s.throughput
        accum = jnp.where(a3, s.accum + contrib, s.accum)

        # Stochastic sample for matte/glossy (3 draws, like every other
        # integrator); dielectric lanes are overridden deterministically.
        next_o, next_d, tmod, rng2 = brdf_ops.sample(hit, s.ray_d, s.rng)

        is_diel = alive & (hit.brdf_kind == BRDF_DIELECTRIC)
        refl_dir, refr_dir, f_refl = brdf_ops.dielectric_split(
            s.ray_d, hit.normal, hit.brdf_param
        )
        # This lane continues as the reflection branch, weight F.
        d3 = is_diel[..., None]
        next_d = jnp.where(d3, refl_dir, next_d)
        next_o = jnp.where(d3, hit.point + refl_dir * EPSILON, next_o)
        tmod = jnp.where(d3, hit.color * f_refl[..., None], tmod)
        new_thpt = s.throughput * tmod

        # Refraction child: weight 1-F, pushed for later traversal; skipped
        # under TIR, negligible throughput, or an exhausted bounce budget.
        child_thpt = s.throughput * hit.color * (1.0 - f_refl)[..., None]
        push = (
            is_diel
            & (f_refl < 1.0)
            & ~linalg.near_zero(child_thpt)
            & (s.depth + 1 < num_bounces)
            & (s.sp < stack_depth)  # full stack -> child dropped
        )
        child_o = hit.point + refr_dir * EPSILON

        stk_o, stk_d, stk_t, stk_depth_a = s.stk_o, s.stk_d, s.stk_t, s.stk_depth
        for slot in range(stack_depth):
            w = push & (s.sp == slot)
            w3 = w[..., None]
            stk_o = stk_o.at[slot].set(jnp.where(w3, child_o, stk_o[slot]))
            stk_d = stk_d.at[slot].set(jnp.where(w3, refr_dir, stk_d[slot]))
            stk_t = stk_t.at[slot].set(jnp.where(w3, child_thpt, stk_t[slot]))
            stk_depth_a = stk_depth_a.at[slot].set(
                jnp.where(w, s.depth + 1, stk_depth_a[slot])
            )
        sp = jnp.where(push, s.sp + 1, s.sp)

        # Advance surviving segments.
        ray_o = jnp.where(a3, next_o, s.ray_o)
        ray_d = jnp.where(a3, next_d, s.ray_d)
        depth = jnp.where(alive, s.depth + 1, s.depth)
        throughput = jnp.where(a3, new_thpt, jnp.zeros_like(s.throughput))
        rng = jnp.where(a3, rng2, s.rng)

        # Lanes whose segment just died pop their deepest pending child and
        # resume with it next step (fresh draws from the same lane stream).
        pop = (s.live & ~alive) & (sp > 0)
        top = sp - 1
        pop_o = jnp.zeros_like(ray_o)
        pop_d = jnp.zeros_like(ray_d)
        pop_t = jnp.zeros_like(throughput)
        pop_depth = jnp.zeros_like(depth)
        for slot in range(stack_depth):
            m = (top == slot)[..., None]
            pop_o = jnp.where(m, stk_o[slot], pop_o)
            pop_d = jnp.where(m, stk_d[slot], pop_d)
            pop_t = jnp.where(m, stk_t[slot], pop_t)
            pop_depth = jnp.where(top == slot, stk_depth_a[slot], pop_depth)
        p3 = pop[..., None]
        ray_o = jnp.where(p3, pop_o, ray_o)
        ray_d = jnp.where(p3, pop_d, ray_d)
        throughput = jnp.where(p3, pop_t, throughput)
        depth = jnp.where(pop, pop_depth, depth)
        sp = jnp.where(pop, sp - 1, sp)
        live = alive | pop

        return _S(
            step=s.step + 1,
            count=jnp.sum(live).astype(jnp.int32),
            ray_o=ray_o,
            ray_d=ray_d,
            depth=depth,
            throughput=throughput,
            accum=accum,
            rng=rng,
            live=live,
            sp=sp,
            stk_o=stk_o,
            stk_d=stk_d,
            stk_t=stk_t,
            stk_depth=stk_depth_a,
            occupancy=occupancy,
        )

    final = jax.lax.while_loop(cond, body, state)

    # Lane i is pixel i: positional accumulate + positional RNG write-back,
    # no scatter at all.
    out = Accumulator(
        color=acc.color + final.accum.reshape(height, width, 3),
        rng=final.rng.reshape(height, width, 4),
        iterations=acc.iterations + 1,
    )
    if return_stats:
        return out, WavefrontStats(
            occupancy=final.occupancy, capacity=num_pixels * max_steps
        )
    return out


def render_batch_wavefront(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    return_stats: bool = False,
    row_offset=0,
    full_height: int | None = None,
):
    """`spp` wavefront samples in one dispatch (on-device sample loop).

    With `return_stats=True` also returns :class:`WavefrontStats` whose
    occupancy is summed over the batch's samples (divide by `spp` for the
    mean per-bounce live population).
    """
    if return_stats:

        def body_s(_, carry):
            a, occ = carry
            a, stats = render_sample_wavefront(
                scene, camera, a, num_bounces, russian_roulette,
                return_stats=True, row_offset=row_offset,
                full_height=full_height,
            )
            return a, occ + stats.occupancy

        occ0 = jnp.zeros((num_bounces + 1,), jnp.int32)
        out, occ = jax.lax.fori_loop(0, spp, body_s, (acc, occ0))
        h, w = acc.color.shape[:2]
        return out, WavefrontStats(occupancy=occ, capacity=h * w)

    def body(_, a):
        return render_sample_wavefront(
            scene, camera, a, num_bounces, russian_roulette,
            row_offset=row_offset, full_height=full_height,
        )

    return jax.lax.fori_loop(0, spp, body, acc)


def render_batch_wavefront_split(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    num_bounces: int = 15,
    queue_factor: float = 2.0,
    return_stats: bool = False,
    row_offset=0,
    full_height: int | None = None,
):
    """`spp` deterministic-splitting samples in one dispatch.

    The batched form of :func:`render_sample_wavefront_split`; with
    `return_stats=True` the occupancy telemetry (which includes enqueued
    child rays — lane counts above the pixel count are split children) is
    summed over the batch.
    """
    if return_stats:

        def body_s(_, carry):
            a, occ = carry
            a, stats = render_sample_wavefront_split(
                scene, camera, a, num_bounces, queue_factor,
                return_stats=True, row_offset=row_offset,
                full_height=full_height,
            )
            return a, occ + stats.occupancy

        occ0 = jnp.zeros((num_bounces + 1,), jnp.int32)
        out, occ = jax.lax.fori_loop(0, spp, body_s, (acc, occ0))
        h, w = acc.color.shape[:2]
        slots = max(1, min(num_bounces - 1, int(round(queue_factor))))
        max_steps = num_bounces * (1 + slots)
        return out, WavefrontStats(occupancy=occ, capacity=h * w * max_steps)

    def body(_, a):
        return render_sample_wavefront_split(
            scene, camera, a, num_bounces, queue_factor,
            row_offset=row_offset, full_height=full_height,
        )

    return jax.lax.fori_loop(0, spp, body, acc)
