"""Renderer driver: compile-once / step-many progressive rendering.

Host-side equivalent of the reference's application core
(upstream app/Main.hs): `compileFor` fixes the pixel grid and
algorithm while the camera stays a runtime argument (Main.hs:185-191);
`computationLoop` runs one sample per dispatch, switching to batches of
`max(30, iters/50)` once past 100 iterations (Main.hs:204-211); every 2000
iterations the per-pixel RNGs are reseeded from host entropy
(Main.hs:217-239); moving the camera resets the accumulator but reuses the
same compiled function (Main.hs:305-321).

This redesign collapses the reference's three OS threads + MVar
(Main.hs:178-183) into a single host loop: device execution is already
asynchronous under JAX, so dispatching the next jitted step overlaps with
reading back the previous image.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import numpy as np

from ..models.objects import Accumulator, Camera, Scene
from ..ops import rng as rng_ops
from ..ops import routes
from ..utils.config import RenderConfig
from . import integrator
from .wavefront import render_batch_wavefront


class Renderer:
    """Progressive path tracer bound to a (resolution, algorithm, bounces)
    configuration — the `compileFor` boundary (Main.hs:188-191).

    Scene, camera and accumulator are traced arguments: changing any of them
    (camera motion, inverse-rendering updates) never recompiles.
    """

    def __init__(self, config: RenderConfig):
        self.config = config
        self._takes_dielectric_flag = False
        self._takes_kinds_flag = False
        if config.algorithm == "inline":
            # The capability check runs here, so an explicit "pallas" on a
            # platform without the kernel fails at construction.
            if routes.use_kernel(config.kernel, "parity"):
                step_fn = integrator.render_batch_pallas
                self._takes_dielectric_flag = True
            else:
                step_fn = integrator.render_batch_inline
            step = partial(
                step_fn,
                num_bounces=config.bounces,
                russian_roulette=config.russian_roulette,
            )
        elif config.algorithm == "wavefront":
            if config.split:
                from .wavefront import render_batch_wavefront_split

                step = partial(
                    render_batch_wavefront_split,
                    num_bounces=config.bounces,
                    queue_factor=config.queue_factor,
                )
            else:
                step = partial(
                    render_batch_wavefront,
                    num_bounces=config.bounces,
                    russian_roulette=config.russian_roulette,
                )
        elif config.algorithm == "physical":
            from .nee import (
                render_batch_physical,
                render_batch_physical_stateless,
            )

            if config.sampler == "threefry":
                step = partial(
                    render_batch_physical_stateless,
                    num_bounces=config.bounces,
                    nee=config.nee,
                )
            else:
                step = partial(
                    render_batch_physical,
                    num_bounces=config.bounces,
                    nee=config.nee,
                )
            # BRDF-kind elision needs the concrete (host-side) scene;
            # inside jit the materials are tracers, so the static kind
            # set rides in as a hashable static argument.
            self._takes_kinds_flag = True
        else:
            raise ValueError(f"unknown algorithm {config.algorithm!r}")
        # spp must be static (it is a fori_loop bound); donate the
        # accumulator so progressive rendering updates it in place on device.
        if self._takes_dielectric_flag:
            self._step = jax.jit(
                lambda scene, camera, acc, spp, has_dielectric: step(
                    scene, camera, acc, spp, has_dielectric=has_dielectric
                ),
                static_argnames=("spp", "has_dielectric"),
                donate_argnames=("acc",),
            )
        elif self._takes_kinds_flag:
            self._step = jax.jit(
                lambda scene, camera, acc, spp, kinds: step(
                    scene, camera, acc, spp, kinds=kinds
                ),
                static_argnames=("spp", "kinds"),
                donate_argnames=("acc",),
            )
        else:
            self._step = jax.jit(
                lambda scene, camera, acc, spp: step(scene, camera, acc, spp),
                static_argnames=("spp",),
                donate_argnames=("acc",),
            )

    def init_accumulator(self, seed: Optional[int] = None) -> Accumulator:
        return integrator.make_accumulator(
            self.config.width, self.config.height, seed=seed
        )

    def step(self, scene: Scene, camera: Camera, acc: Accumulator, spp: int = 1):
        """Render `spp` more samples into the accumulator (async dispatch)."""
        if self._takes_dielectric_flag:
            # Scene arrays are concrete here (host side), so the glass-free
            # fact is a cheap static input; flipping it just retraces once.
            return self._step(
                scene, camera, acc, spp, self._scene_has_dielectric(scene)
            )
        if self._takes_kinds_flag:
            from .nee import _present_kinds

            return self._step(scene, camera, acc, spp, _present_kinds(scene))
        return self._step(scene, camera, acc, spp)

    @staticmethod
    def _scene_has_dielectric(scene: Scene) -> bool:
        from ..ops.pallas_megakernel import scene_has_dielectric

        return scene_has_dielectric(scene)

    def batch_size(self, iterations: int) -> int:
        """The reference's responsiveness/throughput schedule
        (Main.hs:204-211): single samples for the first 100 iterations, then
        batches of max(30, iterations // 50)."""
        if iterations < 100:
            return 1
        return max(30, iterations // 50)

    def should_reseed(self, prev_iters: int, new_iters: int) -> bool:
        """Reseed every `reseed_interval` samples (Main.hs:236-239)."""
        k = self.config.reseed_interval
        return (prev_iters // k) != (new_iters // k)

    def reseed(self, acc: Accumulator, seed: Optional[int] = None) -> Accumulator:
        return rng_ops.reseed(
            (self.config.height, self.config.width), acc, seed=seed
        )

    def render(
        self,
        scene: Scene,
        camera: Camera,
        total_spp: int,
        seed: Optional[int] = None,
        progress: bool = False,
    ) -> Accumulator:
        """Render `total_spp` samples with the reference's batching and
        reseeding schedule, returning the final accumulator."""
        acc = self.init_accumulator(seed=seed)
        done = 0
        while done < total_spp:
            n = min(self.batch_size(done), total_spp - done)
            prev = done
            acc = self.step(scene, camera, acc, spp=n)
            done += n
            if self.should_reseed(prev, done):
                acc = self.reseed(acc, seed=None if seed is None else seed + done)
            if progress:
                print(f"  {done}/{total_spp} spp", flush=True)
        return acc

    def image(self, acc: Accumulator) -> np.ndarray:
        """Normalized (divided-by-iterations) image on host."""
        return np.asarray(acc.image)

    def wavefront_stats(self, scene: Scene, camera: Camera, acc: Accumulator):
        """One probe sample's wavefront telemetry (occupancy per bounce +
        bounce-depth histogram), without touching the accumulator.  Only
        meaningful for the wavefront algorithm; other variants return None.
        """
        if self.config.algorithm != "wavefront":
            return None
        from .wavefront import (
            depth_histogram,
            render_sample_wavefront,
            render_sample_wavefront_split,
        )

        @partial(jax.jit, static_argnames=("bounces",))
        def probe(scene, camera, acc, bounces):
            if self.config.split:
                _, stats = render_sample_wavefront_split(
                    scene, camera, acc, num_bounces=bounces,
                    queue_factor=self.config.queue_factor,
                    return_stats=True,
                )
            else:
                _, stats = render_sample_wavefront(
                    scene, camera, acc, num_bounces=bounces,
                    russian_roulette=self.config.russian_roulette,
                    return_stats=True,
                )
            return stats.occupancy, depth_histogram(stats), stats.capacity

        occ, hist, cap = probe(scene, camera, acc, self.config.bounces)
        return {
            "occupancy": np.asarray(occ).tolist(),
            "depth_histogram": np.asarray(hist).tolist(),
            "capacity": int(cap),
        }
