"""SPMD rendering and training steps over a device mesh (shard_map).

The reference's only parallelism is data-parallel pixels on one device
(SURVEY.md §2.3).  Here the same pure render step runs under `shard_map`:

  * forward rendering: the accumulator (color+rng) is row-sharded over the
    `tile` axis; each device generates primary rays for its own row block
    (`row_offset = axis_index * block_h`) and runs the full bounce loop
    locally — zero collectives in the forward hot loop (the scene is
    replicated);
  * spp sharding: the `sample` axis renders the same tile with independent
    RNG streams; radiance is `psum`-ed across the axis;
  * inverse rendering: each device differentiates the loss on its block;
    scene-parameter gradients are `psum`-ed over the whole mesh — the one
    place collectives carry the training traffic (BASELINE.md north star).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..diff import grad as G
from ..models.objects import Accumulator, Camera, Scene
from ..render import integrator
from .mesh import SAMPLE_AXIS, TILE_AXIS, accumulator_sharding


def _acc_specs():
    return Accumulator(color=P(TILE_AXIS), rng=P(TILE_AXIS), iterations=P())


def place_accumulator(acc: Accumulator, mesh: Mesh) -> Accumulator:
    """Device-put an accumulator with rows sharded over the tile axis."""
    sh = accumulator_sharding(mesh)
    return Accumulator(
        color=jax.device_put(acc.color, sh),
        rng=jax.device_put(acc.rng, sh),
        iterations=jax.device_put(
            acc.iterations, NamedSharding(mesh, P())
        ),
    )


def render_sharded(
    scene: Scene,
    camera: Camera,
    acc: Accumulator,
    spp: int,
    mesh: Mesh,
    num_bounces: int = 15,
    russian_roulette: bool = False,
    algorithm: str = "inline",
    nee: bool = True,
    queue_factor: float = 2.0,
    kernel: str = "auto",
):
    """Tile-sharded progressive render step (jit-compatible; `spp`,
    `num_bounces`, `algorithm` static).

    `algorithm`: "inline" (parity megakernel, through the route `kernel`
    resolves to, ops/routes.py), "physical" (corrected
    BRDFs + NEE, render/nee.py), "wavefront" (queue formulation), or
    "split" (wavefront with deterministic dielectric splitting — sharded
    glass rendering).  All trace each device's row block locally with
    zero collectives — the scene is replicated, so NEE shadow rays and
    split children stay on-device; the wavefront per-lane accumulate is
    positional within the block."""
    full_height = acc.color.shape[0]
    n_tile = mesh.shape[TILE_AXIS]
    assert full_height % n_tile == 0, (full_height, n_tile)
    block_h = full_height // n_tile
    if algorithm not in ("inline", "physical", "wavefront", "split"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    # Static facts from the (usually concrete) scene before shard_map
    # traces it: the BRDF kind set (branch elision) and whether any
    # material is glass (the kernel's glass block).
    from ..ops.pallas_megakernel import scene_has_dielectric
    from ..render.nee import _present_kinds

    kinds = _present_kinds(scene)
    has_dielectric = scene_has_dielectric(scene)

    def local_step(scene, camera, acc_block):
        row0 = jax.lax.axis_index(TILE_AXIS) * block_h
        if algorithm == "physical":
            from ..render.nee import render_batch_physical

            return render_batch_physical(
                scene,
                camera,
                acc_block,
                spp,
                num_bounces,
                nee=nee,
                row_offset=row0,
                full_height=full_height,
                kinds=kinds,
            )
        if algorithm == "wavefront":
            from ..render.wavefront import render_batch_wavefront

            return render_batch_wavefront(
                scene, camera, acc_block, spp, num_bounces,
                russian_roulette, row_offset=row0,
                full_height=full_height,
            )
        if algorithm == "split":
            from ..render.wavefront import render_batch_wavefront_split

            return render_batch_wavefront_split(
                scene, camera, acc_block, spp, num_bounces,
                queue_factor=queue_factor, row_offset=row0,
                full_height=full_height,
            )
        return integrator.render_batch_auto(
            scene,
            camera,
            acc_block,
            spp,
            num_bounces,
            russian_roulette,
            row_offset=row0,
            full_height=full_height,
            has_dielectric=has_dielectric,
            kernel=kernel,
        )

    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), _acc_specs()),
        out_specs=_acc_specs(),
        check_vma=False,
    )(scene, camera, acc)


def render_radiance_sharded(
    scene: Scene,
    camera: Camera,
    rng_states: jnp.ndarray,
    mesh: Mesh,
    width: int,
    height: int,
    num_bounces: int = 4,
    spp_per_shard: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    interpret: bool = False,
):
    """Expected radiance with tiles AND samples sharded.

    `rng_states` is [n_sample, height, width, 4]: axis 0 sharded over
    `sample`, rows over `tile`.  Each (tile, sample) shard renders
    `spp_per_shard` samples of its block; the sample axis mean is a `psum`.
    Returns the full radiance image [height, width, 3] (tile-sharded,
    sample-replicated).

    `backend` picks the route (ops/routes.py): "pallas" runs each shard's
    fwd+bwd through the fused differentiable megakernel
    (ops/pallas_megakernel_vjp.py); "xla" is the portable
    rematerialized-scan path; "auto" takes the platform's fast route.
    `interpret` runs Pallas in interpret mode (tests only).
    """
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    assert height % n_tile == 0 and rng_states.shape[0] == n_sample
    block_h = height // n_tile

    def local(scene, camera, rng_block):
        row0 = jax.lax.axis_index(TILE_AXIS) * block_h
        local_mean = G.render_radiance(
            scene, camera, rng_block[0], width, block_h, num_bounces,
            spp=spp_per_shard, backend=backend,
            has_dielectric=has_dielectric, row_offset=row0,
            full_height=height, interpret=interpret,
        )
        return jax.lax.pmean(local_mean, SAMPLE_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(SAMPLE_AXIS, TILE_AXIS)),
        out_specs=P(TILE_AXIS),
        check_vma=False,
    )(scene, camera, rng_states)


def train_step_sharded(
    params: G.SceneParams,
    template: Scene,
    camera: Camera,
    target: jnp.ndarray,
    rng_states: jnp.ndarray,
    mesh: Mesh,
    num_bounces: int = 4,
    lr: float = 1e-2,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    interpret: bool = False,
    estimator: str = "parity",
    kinds=None,
):
    """One inverse-rendering SGD step with rays + grads sharded.

    `target` [H,W,3] and `rng_states` [H,W,4] are tile-sharded; params are
    replicated.  Each device renders + differentiates its block; scene-param
    gradients `psum` over the mesh (the backward-sweep all-reduce of the
    north star).  Returns (new_params, loss) — both replicated.

    `backend` picks the route (ops/routes.py): "pallas" differentiates
    each block through the fused fwd+bwd megakernel
    (ops/pallas_megakernel_vjp.py) — the kernel the headline bench
    measures, now under the psum all-reduce; "xla" is the portable
    rematerialized path; "auto" takes the platform's fast route.

    `estimator="physical"` trains against the corrected-BRDF + NEE
    estimator (XLA on every platform).
    """
    full_height = target.shape[0]
    n_tile = mesh.shape[TILE_AXIS]
    block_h = full_height // n_tile
    width = target.shape[1]
    denom = float(target.size)

    def local(params, template, camera, tgt_block, rng_block):
        row0 = jax.lax.axis_index(TILE_AXIS) * block_h

        def local_loss(p):
            scene = G.params_to_scene(p, template)
            rad = G.render_radiance(
                scene, camera, rng_block, width, block_h, num_bounces,
                spp=1, backend=backend, has_dielectric=has_dielectric,
                row_offset=row0, full_height=full_height,
                interpret=interpret, estimator=estimator, kinds=kinds,
            )
            return jnp.sum((rad - tgt_block) ** 2) / denom

        loss, grads = jax.value_and_grad(local_loss)(params)
        # The gradient all-reduce: sum over tiles = global grad; sample
        # shards (if any) hold replicas of the same tile, so mean there.
        reduce = lambda g: jax.lax.pmean(
            jax.lax.psum(g, TILE_AXIS), SAMPLE_AXIS
        )
        grads = jax.tree_util.tree_map(reduce, grads)
        loss = reduce(loss)
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g, params, grads
        )
        return new_params, loss

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(params, template, camera, target, rng_states)
