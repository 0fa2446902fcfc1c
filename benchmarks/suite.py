"""Benchmark suite over the BASELINE.md configs.

Prints one JSON line per config (bench.py at the repo root is the
single-line headline).  Needs nothing but JAX; on a GPU the parity configs
take the route ops/routes.py picks (the Pallas kernels), everything else
runs on XLA.

    python benchmarks/suite.py            # all configs
    python benchmarks/suite.py 1 4        # a subset

Configs (BASELINE.json):
  1. parity scene  — 1 diffuse sphere + plane, 256x256 / 4 spp / 2 bounces
  2. Cornell-ish   — 8 spheres, 512x512 / 16 spp / 4 bounces
  3. dielectric    — glass with ray splitting, 512x512 / 64 spp / 8 bounces
  4. large scene   — 1920x1088, 1000 spheres, NEE / 4 bounces (timed over
                     16 of the specified 256 spp: the rate is per sample)
  5. inverse       — parity gradient step at 3840x2160 and 512x512
  6. physical NEE  — the production estimator on the Cornell scene
  7. physical grad — NEE gradient step on the 1000-sphere scene
  8. tri emitters  — NEE with triangle area lights on the Cornell scene

Every config is timed the same way: a chain of `k` dependent dispatches
(renderers and trainers enqueue without blocking), best of `n`, with the
single-dispatch latency reported alongside.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp


def _timeit(fn, n=3):
    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def _pipeline(step, state, k, n=2):
    """(single-dispatch seconds, seconds for a chain of `k` dependent
    dispatches)."""

    def chained(s):
        for _ in range(k):
            s = step(s)
        return s

    return _timeit(lambda: step(state), n=n), _timeit(
        lambda: chained(state), n=n
    )


TARGET_RAYS_PER_S = 5.0e8  # BASELINE.json north star (rays/s/chip)


def _report(config, name, rays, seconds, extra=None):
    rec = {
        "config": config,
        "metric": name,
        "value": rays / seconds,
        "unit": "rays/s",
        "seconds": seconds,
        "vs_baseline": rays / seconds / TARGET_RAYS_PER_S,
    }
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)


def parity_scene():
    from haskell_path_tracer.models.objects import (
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )

    s = make_spheres(
        [[0.0, 0.0, -5.0]],
        [1.5],
        make_materials([([0.8, 0.5, 0.4], 1.5, BRDF_MATTE, 1.0)]),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.7, 0.6], 0.0, BRDF_MATTE, 1.2)]),
    )
    return Scene(spheres=s, planes=p)


def cornell_scene():
    from haskell_path_tracer.models.objects import (
        BRDF_GLOSSY,
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )

    rng = np.random.default_rng(0)
    pos = rng.uniform([-3, -2, -8], [3, 2, -4], (8, 3))
    mats = make_materials(
        [
            (rng.uniform(0.2, 0.9, 3).tolist(),
             30.0 if i == 0 else 0.0,
             BRDF_GLOSSY if i % 3 == 2 else BRDF_MATTE,
             0.9)
            for i in range(8)
        ]
    )
    s = make_spheres(pos.tolist(), rng.uniform(0.4, 1.0, 8).tolist(), mats)
    p = make_planes(
        [[0, -3, 0], [0, 8, 0]],
        [[0, 1, 0], [0, -1, 0]],
        make_materials(
            [([0.7, 0.7, 0.7], 0.0, BRDF_MATTE, 1.2),
             ([0.8, 0.8, 0.8], 0.0, BRDF_MATTE, 1.0)]
        ),
    )
    return Scene(spheres=s, planes=p)


def glass_scene():
    from haskell_path_tracer.models.objects import (
        BRDF_DIELECTRIC,
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )

    s = make_spheres(
        [[0.0, 0.0, -4.0], [1.8, 0.5, -6.0]],
        [1.3, 0.9],
        make_materials(
            [([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5),
             ([0.9, 0.95, 1.0], 0.0, BRDF_DIELECTRIC, 1.33)]
        ),
    )
    p = make_planes(
        [[0.0, 0.0, -9.0], [0.0, -3.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
        make_materials(
            [([1.0, 0.9, 0.7], 3.0, BRDF_MATTE, 1.0),
             ([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)]
        ),
    )
    return Scene(spheres=s, planes=p)


def big_scene(n=1000):
    from haskell_path_tracer.models.objects import (
        BRDF_MATTE,
        Scene,
        make_materials,
        make_planes,
        make_spheres,
    )

    rng = np.random.default_rng(7)
    pos = rng.uniform([-30, -2.5, -60], [30, 10, -8], (n, 3))
    radius = rng.uniform(0.2, 0.9, n)
    illum = np.where(rng.random(n) < 0.01, 50.0, 0.0)  # ~10 lights
    mats = make_materials(
        [
            (rng.uniform(0.2, 0.9, 3).tolist(), float(illum[i]),
             BRDF_MATTE, 1.0)
            for i in range(n)
        ]
    )
    s = make_spheres(pos.tolist(), radius.tolist(), mats)
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.6], 0.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=s, planes=p)


def _render_config(config, name, scene, cam, w, h, spp, k, render,
                   segments_per_sample, n=2, note=None):
    import haskell_path_tracer as hpt

    acc = hpt.make_accumulator(w, h, seed=0)
    step = jax.jit(lambda s, c, a: render(s, c, a, spp))
    dt1, dtk = _pipeline(lambda a: step(scene, cam, a), acc, k, n=n)
    extra = {"pipeline": k, "single_ms": dt1 * 1e3}
    if note:
        extra["note"] = note
    _report(config, name, w * h * spp * segments_per_sample * k, dtk, extra)


def _auto(b):
    """The inline estimator on its fastest route; configs 1 and 2 hold no
    glass, so the kernel's dielectric block is elided."""
    from haskell_path_tracer.render.integrator import render_batch_auto

    return lambda s, c, a, spp: render_batch_auto(
        s, c, a, spp=spp, num_bounces=b, has_dielectric=False)


def _physical(scene, b):
    from haskell_path_tracer.render.nee import (
        _present_kinds,
        render_batch_physical,
    )

    # Static fact from the concrete scene, outside jit: the BRDF kind set
    # (absent-material branch elision).
    kinds = _present_kinds(scene)
    return lambda s, c, a, spp: render_batch_physical(
        s, c, a, spp=spp, num_bounces=b, nee=True, kinds=kinds)


def config1():
    import haskell_path_tracer as hpt
    from haskell_path_tracer.ops import routes

    b = 2
    _render_config(
        1, f"parity_256x256x4sppx2b_{routes.fast_route('parity')}",
        parity_scene(), hpt.initial_camera(), 256, 256, 4, 64, _auto(b), b,
    )


def config2():
    import haskell_path_tracer as hpt
    from haskell_path_tracer.ops import routes

    b = 4
    _render_config(
        2, f"cornell8_512x512x16sppx4b_{routes.fast_route('parity')}",
        cornell_scene(), hpt.initial_camera(), 512, 512, 16, 8, _auto(b), b,
    )


def config3():
    from haskell_path_tracer.models.objects import Camera
    from haskell_path_tracer.render.wavefront import (
        render_batch_wavefront_split,
    )

    b = 8
    _render_config(
        3, "glass_split_512x512x64sppx8b_xla", glass_scene(),
        Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0),
        512, 512, 64, 4,
        lambda s, c, a, spp: render_batch_wavefront_split(
            s, c, a, spp=spp, num_bounces=b, queue_factor=2.0),
        b, n=1,
    )


def config4():
    from haskell_path_tracer.models.objects import Camera

    scene, b = big_scene(1000), 4
    # NEE traces 2 rays per bounce (bsdf + shadow).
    _render_config(
        4, "big1000_nee_1920x1088x16sppx4b_xla", scene,
        Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0),
        1920, 1088, 16, 1, _physical(scene, b), 2 * b, n=1,
        note="rays count bsdf+shadow; 16 of the specified 256 spp",
    )


def _grad_config(config, name, scene, cam, w, h, spp, b, k, rays_per_seg,
                 n=2, **loss_kw):
    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.ops.rng import gen_seeds

    params = G.scene_to_params(scene)
    rng = gen_seeds((h, w), seed=1)
    target = jnp.zeros((h, w, 3), jnp.float32)
    lr = 1e-6

    # The whole SGD step under one jit.
    @jax.jit
    def sgd_step(p):
        g = jax.grad(lambda q: G.image_loss(
            q, scene, cam, target, rng, num_bounces=b, spp=spp, **loss_kw))(p)
        return jax.tree_util.tree_map(lambda a, d: a - lr * d, p, g)

    dt1, dtk = _pipeline(sgd_step, params, k, n=n)
    # Segments counted ONCE per fwd+bwd step (bench.py's rule).
    _report(config, name, w * h * spp * b * rays_per_seg * k, dtk,
            {"pipeline": k, "single_ms": dt1 * 1e3,
             "note": "fwd+bwd step; segments counted once"})


def config5():
    import haskell_path_tracer as hpt
    from haskell_path_tracer.ops import routes

    route = routes.fast_route("parity_grad")
    scene, cam = cornell_scene(), hpt.initial_camera()
    _grad_config(5, f"invrender_grad_4k_3840x2160x1sppx4b_{route}", scene,
                 cam, 3840, 2160, 1, 4, 4, 1, has_dielectric=False)
    _grad_config(5, f"invrender_grad_512x512x1sppx4b_{route}", scene, cam,
                 512, 512, 1, 4, 16, 1, has_dielectric=False)


def config6():
    import haskell_path_tracer as hpt

    scene, b = cornell_scene(), 4
    _render_config(
        6, "cornell8_nee_512x512x16sppx4b_xla", scene, hpt.initial_camera(),
        512, 512, 16, 8, _physical(scene, b), 2 * b,
        note="rays count bsdf+shadow; compare config 2 (parity mode)",
    )


def config7():
    from haskell_path_tracer.models.objects import Camera
    from haskell_path_tracer.render.nee import _present_kinds

    # XLA's compile of this step ran past 8 minutes on an H100 (PERF.md,
    # "H100"): run it on its own (`suite.py 7`) with time to spare.
    scene = big_scene(1000)
    cam = Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0)
    kw = dict(estimator="physical", kinds=_present_kinds(scene))
    _grad_config(7, "invrender_phys_nee_grad_big1000_512x512x1sppx4b_xla",
                 scene, cam, 512, 512, 1, 4, 8, 2, **kw)
    _grad_config(7, "invrender_phys_nee_grad_big1000_1920x1088x2sppx4b_xla",
                 scene, cam, 1920, 1088, 2, 4, 2, 2, n=1, **kw)


def config8():
    import haskell_path_tracer as hpt
    from haskell_path_tracer.models.objects import (
        Scene, make_materials, make_triangles,
    )

    base = cornell_scene()
    tr = make_triangles(
        [[-2.5, 7.5, -9.0], [2.5, 7.5, -5.0],
         [-1.5, 0.0, -6.0], [1.0, -1.0, -4.5]],
        [[2.5, 7.5, -9.0], [-2.5, 7.5, -5.0],
         [-0.5, 0.0, -6.5], [2.0, -1.0, -5.0]],
        [[0.0, 7.5, -5.0], [0.0, 7.5, -9.0],
         [-1.0, 1.5, -6.2], [1.5, 0.2, -4.7]],
        make_materials(
            [([1.0, 0.95, 0.8], 18.0, 0, 1.0),
             ([0.9, 0.9, 1.0], 12.0, 0, 1.0),
             ([0.5, 0.5, 0.8], 0.0, 0, 1.0),
             ([0.8, 0.6, 0.4], 0.0, 0, 1.0)]
        ),
    )
    scene, b = Scene(spheres=base.spheres, planes=base.planes, triangles=tr), 4
    _render_config(
        8, "tri_emitters_cornell8+4t_512x512x16sppx4b_xla", scene,
        hpt.initial_camera(), 512, 512, 16, 8, _physical(scene, b), 2 * b,
        note="triangle area lights; rays count bsdf+shadow",
    )


def main():
    from haskell_path_tracer.utils import compile_cache

    compile_cache.configure()
    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5, 6, 8, 7]
    d = jax.devices()[0]
    print(json.dumps({"device": {"platform": d.platform,
                                 "kind": d.device_kind}}), flush=True)
    for n in which:
        try:
            globals()[f"config{n}"]()
        except Exception as e:  # one config's failure must not sink the run
            print(
                json.dumps(
                    {"config": n, "error": f"{type(e).__name__}: {e}"[:400]}
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
