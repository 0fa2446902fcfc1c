"""The kept Pallas kernels against what XLA makes of the plain version.

Times, on the GPU, end to end through the public wrappers:

  fwd_512   forward, 512x512 / 64 spp / 8 bounces (the headline shape)
  fwd_800   forward, 800x600 / 1 spp / 15 bounces (the CLI's default)
  grad_512  fwd+bwd gradient of sum(radiance), 512x512 / 64 spp / 8 bounces

each for the Triton kernel and for the XLA formulation, on the reference
scene, and checks agreement (RNG bit-equal share, radiance rtol share,
scene-cotangent rtol).  Prints one JSON line per measurement.  Refuses to
run without a GPU.

    python benchmarks/kernels.py                  # everything
    python benchmarks/kernels.py fwd_512 grad_512 # a subset
    python benchmarks/kernels.py --sweep          # block / warp sweep
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

SHAPES = {
    "fwd_512": (512, 512, 64, 8),
    "fwd_800": (800, 600, 1, 15),
    "grad_512": (512, 512, 64, 8),
}


def device_record():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def timed(jitted, args, reps):
    """(compile seconds, median steady seconds) of `jitted(*args)`.  The
    compile seconds are lowering plus XLA/Triton compilation, timed
    apart from any run; they are cold only if the persistent compile
    cache holds no entry for this program (run with
    JAX_COMPILATION_CACHE_DIR pointing at an empty directory)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, statistics.median(times)


def agreement(rng_a, rng_b, rad_a, rad_b, rtol=1e-5):
    """Share of lanes with bit-equal RNG, and share with radiance within
    `rtol` (plus a 1e-6 floor for near-zero lanes)."""
    rng_a, rng_b = np.asarray(rng_a), np.asarray(rng_b)
    rad_a, rad_b = np.asarray(rad_a), np.asarray(rad_b)
    rng_eq = (rng_a == rng_b).all(-1).mean()
    close = np.isclose(rad_a, rad_b, rtol=rtol, atol=1e-6).all(-1).mean()
    return float(rng_eq), float(close)


def _setup(w, h):
    from haskell_path_tracer.models import world
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.ops.rng import gen_seeds

    scene, cam = world.main_scene(), world.initial_camera()
    return scene, primary_rays(cam, w, h), gen_seeds((h, w), seed=0)


def forward(name, reps=5):
    from haskell_path_tracer.ops import pallas_megakernel as PM
    from haskell_path_tracer.render.integrator import trace_inline

    w, h, spp, b = SHAPES[name]
    scene, rays, rng = _setup(w, h)

    tri = jax.jit(lambda s, r: PM.trace_inline_pallas(
        s, rays, r, num_bounces=b, spp=spp, has_dielectric=False))

    def xla_fn(s, r):
        def body(_, c):
            rad, r = c
            out, r = trace_inline(s, rays, r, b)
            return rad + out, r
        return jax.lax.fori_loop(
            0, spp, body, (jnp.zeros((h, w, 3), jnp.float32), r))

    xla = jax.jit(xla_fn)
    out = {}
    for tag, fn in (("triton", tri), ("xla", xla)):
        compile_s, dt = timed(fn, (scene, rng), reps)
        out[tag] = fn(scene, rng)
        seg = w * h * spp * b
        print(json.dumps({
            "measure": name, "route": tag, "block": PM.BLOCK,
            "num_warps": PM.NUM_WARPS,
            "seconds": dt, "compile_seconds": compile_s,
            "rays_per_s": seg / dt, "device": device_record(),
        }), flush=True)
    rng_eq, close = agreement(out["xla"][1], out["triton"][1],
                              out["xla"][0], out["triton"][0])
    print(json.dumps({"measure": name, "check": "triton_vs_xla",
                      "rng_bit_equal": rng_eq, "radiance_rtol1e-5": close}),
          flush=True)
    return rng_eq, close


def gradient(name="grad_512", reps=3):
    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.models import world
    from haskell_path_tracer.ops import pallas_megakernel_vjp as V

    w, h, spp, b = SHAPES[name]

    scene, cam = world.main_scene(), world.initial_camera()
    _, _, rng = _setup(w, h)
    params = G.scene_to_params(scene)

    def loss(p, backend):
        img = G.render_radiance(
            G.params_to_scene(p, scene), cam, rng, w, h, num_bounces=b,
            spp=spp, backend=backend, has_dielectric=False)
        return jnp.sum(img)

    grads = {}
    for tag, backend in (("triton", "pallas"), ("xla", "xla")):
        fn = jax.jit(jax.grad(functools.partial(loss, backend=backend)))
        compile_s, dt = timed(fn, (params,), reps)
        grads[tag] = fn(params)
        print(json.dumps({
            "measure": name, "route": tag,
            "bwd_block": V.BWD_BLOCK, "bwd_num_warps": V.BWD_NUM_WARPS,
            "seconds": dt, "compile_seconds": compile_s,
            "rays_per_s": w * h * spp * b / dt, "device": device_record(),
        }), flush=True)
    worst = 0.0
    leaves = {}
    for field in G.SceneParams._fields:
        a = np.asarray(getattr(grads["triton"], field))
        x = np.asarray(getattr(grads["xla"], field))
        if not x.size:
            continue
        err = float(np.abs(a - x).max() / (np.abs(x).max() + 1e-30))
        leaves[field] = {
            "max_norm_err": err,
            "rtol1e-4_share": float(
                np.isclose(a, x, rtol=1e-4, atol=0.0).mean()),
        }
        worst = max(worst, err)
    print(json.dumps({"measure": name, "check": "grad_triton_vs_xla",
                      "max_norm_err": worst, "leaves": leaves}), flush=True)
    return worst


@contextlib.contextmanager
def _blocking(module, **consts):
    """Set a kernel module's lane-block constants for the duration."""
    old = {k: getattr(module, k) for k in consts}
    for k, v in consts.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def sweep():
    from haskell_path_tracer.ops import pallas_megakernel as PM
    from haskell_path_tracer.ops import pallas_megakernel_vjp as V

    for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8)):
        with _blocking(PM, BLOCK=block, NUM_WARPS=warps):
            forward("fwd_512", reps=3)
    for block, warps in ((32, 1), (64, 2), (128, 4)):
        # The custom-VJP builder is cached per static config: drop it so
        # the backward is traced again with these constants.
        V._make_diff_fn.cache_clear()
        with _blocking(V, BWD_BLOCK=block, BWD_NUM_WARPS=warps):
            gradient(reps=2)


def main(argv):
    from haskell_path_tracer.utils import compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("benchmarks/kernels.py needs a GPU")
    compile_cache.configure()
    if "--sweep" in argv:
        return sweep()
    for name in [a for a in argv if not a.startswith("-")] or list(SHAPES):
        if name.startswith("fwd"):
            forward(name)
        else:
            gradient(name)


if __name__ == "__main__":
    main(sys.argv[1:])
