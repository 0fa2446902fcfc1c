"""Benchmark: fwd+bwd rays/sec/chip on the flagship differentiable path.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
Refuses to run (exit code 2, no JSON line) unless JAX's first device is a
GPU: the number is only meaningful for the GPU kernel route.

The headline metric (BASELINE.md:26) is ray segments traced per second per
chip **forward + backward** at 512x512 / 64 spp: one full gradient
evaluation of the inverse-rendering loss through `diff/grad.py:
render_radiance` on the route ops/routes.py picks for the GPU: the fused
forward + backward Pallas kernel, ops/pallas_megakernel_vjp.py.  A "ray
segment" is one intersect+shade lane-step of the bounce
loop: pixels * spp * bounces (dead lanes still occupy their SIMD lane,
exactly as in the reference's Inline algorithm — the backward sweep
re-walks the same segments).  vs_baseline is measured against the 5e8
rays/s/chip north-star target (the reference publishes no numbers —
SURVEY.md §6).
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

WIDTH, HEIGHT = 512, 512
SPP = 64  # BASELINE.md headline config: 512x512 / 64 spp
BOUNCES = 8
TARGET_RAYS_PER_S = 5.0e8


def main() -> int:
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py needs a GPU (JAX found {device.platform})",
              file=sys.stderr)
        return 2

    from haskell_path_tracer.diff.grad import (
        params_to_scene,
        render_radiance,
        scene_to_params,
    )
    from haskell_path_tracer.models import world
    from haskell_path_tracer.ops import rng as rng_ops
    from haskell_path_tracer.ops.pallas_megakernel import scene_has_dielectric
    from haskell_path_tracer.utils import compile_cache

    compile_cache.configure()
    scene = world.main_scene()
    camera = world.initial_camera()
    rng = rng_ops.gen_seeds((HEIGHT, WIDTH), seed=0)
    params = scene_to_params(scene)

    # Static scene fact computed outside jit: the reference scene has no
    # glass, so the kernel's dielectric block is elided (bit-exact).
    has_diel = scene_has_dielectric(scene)

    def loss(p):
        img = render_radiance(
            params_to_scene(p, scene), camera, rng, WIDTH, HEIGHT,
            num_bounces=BOUNCES, spp=SPP, has_dielectric=has_diel,
        )
        return jnp.sum(img)

    step = jax.jit(jax.grad(loss))

    # Warmup / compile.
    jax.block_until_ready(step(params))

    # Timed: best of 3 rounds of PIPELINE consecutive async dispatches
    # (one barrier at the end).  Gradient-descent loops dispatch without
    # per-step blocking, so back-to-back device time is the production
    # number.
    PIPELINE = 4
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(PIPELINE):
            grads = step(params)
        jax.block_until_ready(grads)
        times.append((time.perf_counter() - t0) / PIPELINE)

    dt = min(times)
    rays_n = WIDTH * HEIGHT * SPP * BOUNCES
    rays_per_s = rays_n / dt
    print(
        json.dumps(
            {
                "metric": (
                    "ray_segments_per_s_chip_fwd+bwd_"
                    f"{WIDTH}x{HEIGHT}x{SPP}sppx{BOUNCES}b"
                ),
                "value": rays_per_s,
                "unit": "rays/s",
                "vs_baseline": rays_per_s / TARGET_RAYS_PER_S,
                "device": {
                    "platform": device.platform,
                    "kind": device.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
