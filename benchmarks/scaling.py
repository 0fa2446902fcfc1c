"""Scaling-efficiency harness: sharded rendering/training throughput
over a device mesh (BASELINE.md north star: ">= 85% scaling efficiency
to >= 2 hosts").

Measures the tile-sharded render step and the psum-reduced training step
at 1, 2, 4, ... devices and reports efficiency relative to 1 device.
On a multi-GPU host, run as-is (devices = real chips; add
`jax.distributed.initialize` via parallel/multihost.py for multi-host).
Without accelerators it runs on a forced-host-device CPU mesh
(--force-cpu N) — numbers then validate the *harness and sharding
semantics*, not hardware scaling (virtual devices share host cores).

    python benchmarks/scaling.py --force-cpu 8 --width 256 --height 256
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--force-cpu", type=int, default=0,
                   help="force N virtual CPU devices (testing the harness)")
    p.add_argument("--distributed", default=None, metavar="I/N@HOST:PORT",
                   help="join a REAL multi-process run as process I of N "
                   "via jax.distributed (coordinator HOST:PORT); measures "
                   "the full global mesh only")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--train", action="store_true",
                   help="also measure the sharded inverse-rendering step")
    p.add_argument("--backend", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="gradient backend for --train: the fused Pallas "
                   "fwd+bwd kernel (GPU) or the rematerialized XLA path; "
                   "auto = the route ops/routes.py picks")
    args = p.parse_args()

    if args.force_cpu:
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.force_cpu}"
        ).strip()

    distributed = False
    if args.distributed:
        # "I/N@HOST:PORT" — must run before any backend initialization.
        from haskell_path_tracer.parallel.multihost import (
            initialize_distributed,
        )

        rank, rest = args.distributed.split("/", 1)
        nproc, coord = rest.split("@", 1)
        distributed = initialize_distributed(
            coord, int(nproc), int(rank)
        )

    import jax
    import jax.numpy as jnp
    import numpy as np

    import haskell_path_tracer as hpt
    from haskell_path_tracer.utils import compile_cache

    compile_cache.configure()
    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.ops.rng import gen_seeds
    from haskell_path_tracer.parallel import mesh as M
    from haskell_path_tracer.parallel.multihost import (
        host_to_global,
        replicate_tree,
    )
    from haskell_path_tracer.parallel.shard import (
        place_accumulator,
        render_sharded,
        train_step_sharded,
    )

    devices = jax.devices()
    virtual = devices[0].platform == "cpu"
    if jax.process_index() == 0:
        print(json.dumps({
            "devices": len(devices), "kind": str(devices[0]),
            "processes": jax.process_count(),
            "virtual_mesh": virtual,
            "note": ("efficiency numbers are meaningless on a virtual CPU "
                     "mesh (all devices share the host cores); this run "
                     "validates sharding semantics only") if virtual else "",
        }), flush=True)

    scene, cam = hpt.main_scene(), hpt.initial_camera()
    w, h = args.width, args.height

    def timeit(fn, n=5):
        jax.block_until_ready(fn())
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        return min(times)

    if distributed:
        # Every process must participate in every computation, so only
        # the full global mesh is measurable; compare the printed rate
        # against a separate single-process baseline for efficiency.
        sizes = [len(devices)]
    else:
        sizes = []
        n = 1
        while n <= len(devices):
            sizes.append(n)
            n *= 2

    base = None
    for nd in sizes:
        mesh = M.make_mesh(n_tile=nd, n_sample=1, devices=devices[:nd])
        host_acc = hpt.make_accumulator(w, h, seed=0)
        if distributed:
            from haskell_path_tracer.models.objects import Accumulator
            from haskell_path_tracer.parallel.mesh import (
                accumulator_sharding,
                replicated,
            )

            acc = Accumulator(
                color=host_to_global(host_acc.color,
                                     accumulator_sharding(mesh)),
                rng=host_to_global(host_acc.rng, accumulator_sharding(mesh)),
                iterations=host_to_global(host_acc.iterations,
                                          replicated(mesh)),
            )
            scene_m, cam_m = replicate_tree(scene, mesh), replicate_tree(
                cam, mesh
            )
        else:
            acc = place_accumulator(host_acc, mesh)
            scene_m, cam_m = scene, cam
        step = jax.jit(
            lambda s, c, a, _mesh=mesh: render_sharded(
                s, c, a, spp=args.spp, mesh=_mesh, num_bounces=args.bounces
            )
        )
        dt = timeit(lambda: step(scene_m, cam_m, acc))
        rays = w * h * args.spp * args.bounces
        rate = rays / dt
        if base is None:
            base = rate
        eff = rate / (base * nd)
        print(json.dumps({
            "step": "render", "devices": nd,
            "rays_per_s": round(rate), "seconds": round(dt, 4),
            "efficiency_vs_1dev": round(eff, 4),
        }), flush=True)

    if args.train:
        base = None
        from haskell_path_tracer.ops import routes

        backend = args.backend
        route = (routes.fast_route("parity_grad") if backend == "auto"
                 else backend)
        params = G.scene_to_params(scene)
        for nd in sizes:
            mesh = M.make_mesh(n_tile=nd, n_sample=1, devices=devices[:nd])
            rng = gen_seeds((h, w), seed=1)
            target = jnp.zeros((h, w, 3), jnp.float32)
            if distributed:
                from haskell_path_tracer.parallel.mesh import (
                    accumulator_sharding,
                )

                sh = accumulator_sharding(mesh)
                rng = host_to_global(rng, sh)
                target = host_to_global(np.asarray(target), sh)
                params = replicate_tree(params, mesh)
                scene_t, cam_t = replicate_tree(scene, mesh), replicate_tree(
                    cam, mesh
                )
            else:
                scene_t, cam_t = scene, cam
            train = jax.jit(
                lambda p, sc, cm, t, r, _mesh=mesh: train_step_sharded(
                    p, sc, cm, t, r, _mesh,
                    num_bounces=min(args.bounces, 4), lr=1e-3,
                    backend=backend,
                )
            )
            dt = timeit(
                lambda: train(params, scene_t, cam_t, target, rng), n=3
            )
            rate = w * h * min(args.bounces, 4) * 3 / dt  # fwd+bwd segments
            if base is None:
                base = rate
            eff = rate / (base * nd)
            print(json.dumps({
                "step": "train", "devices": nd, "backend": route,
                "rays_per_s": round(rate), "seconds": round(dt, 4),
                "efficiency_vs_1dev": round(eff, 4),
            }), flush=True)


if __name__ == "__main__":
    main()
