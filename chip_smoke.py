"""Smoke test of the path tracer on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

One card:
  1. device     the card's name and power limit (nvidia-smi)
  2. cli        the CLI (app/main.py) at the reference's 800x600 / 15
                bounces: inline with kernel=auto, then physical/NEE and the
                split wavefront at a small spp; every PNG written, every
                accumulated image finite and lit
  3. gradient   image_loss SGD steps at bench.py's 512x512 / 64 spp / 8
                bounces, on the route ops/routes.py picks; the loss is
                finite and falls
  4. kernels    the Triton forward kernel vs XLA (on the GPU and on the
                CPU) vs the numpy oracle at 512x512 / 8 bounces; the
                Triton fwd+bwd kernel's scene cotangents vs XLA's at
                512x512 / 8 bounces, lane by lane at 64 spp (on >= 99.5%
                of lanes within rtol 1e-4) and every leaf's jax.grad
                total over the agreeing lanes at 4 spp (rtol 1e-4)
  5. tests      the `chip`-marked tests, in this process

Four cards: `render_sharded` (inline, physical, split) and
`train_step_sharded` on a 4-card mesh, each compared with the same call on
a 1-card mesh.

Each phase prints one JSON line; the card line precedes the last line,
which is {"ok": true, "device": {...}}.  Any failure exits non-zero
without that line, as does a machine whose JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# The knife-edge contract of PARITY.md: lanes whose decisions may flip on
# an ulp of transcendental rounding.
MIN_LANE_SHARE = 0.995
# Scene cotangents, kernel against XLA on the same card.
GRAD_RTOL = 1e-4


def emit(rec):
    print(json.dumps(rec), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return {"cards": out.splitlines()}


def _lit_and_finite(path):
    import numpy as np

    from haskell_path_tracer.utils.checkpoint import load_accumulator

    acc, _ = load_accumulator(path)
    img = np.asarray(acc.image)
    check(np.isfinite(img).all(), f"{path}: non-finite pixels")
    check(np.abs(img).max() > 0, f"{path}: black image")
    return float(img.mean())


def phase_cli(tmp):
    from haskell_path_tracer.app import main as cli

    runs = {
        "inline_auto": ["--variant", "inline", "--kernel", "auto",
                        "--spp", "4"],
        "physical": ["--variant", "physical", "--spp", "2"],
        "streams_split": ["--variant", "streams", "--split", "--spp", "2"],
    }
    rec = {}
    for name, extra in runs.items():
        png = os.path.join(tmp, f"{name}.png")
        ckpt = os.path.join(tmp, f"{name}.npz")
        t0 = time.perf_counter()
        rc = cli.main(
            ["--width", "800", "--height", "600", "--bounces", "15",
             "--seed", "0", "--quiet", "-o", png, "--checkpoint", ckpt]
            + extra
        )
        check(rc == 0, f"cli {name} returned {rc}")
        check(os.path.getsize(png) > 0, f"{png} not written")
        rec[name] = {"mean": _lit_and_finite(ckpt),
                     "seconds": time.perf_counter() - t0}
    return rec


def phase_gradient(steps=3, shape=(512, 512, 64, 8)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.models import world
    from haskell_path_tracer.ops import routes
    from haskell_path_tracer.ops.rng import gen_seeds

    w, h, spp, b = shape  # bench.py's shape
    scene, cam = world.main_scene(), world.initial_camera()
    rng = gen_seeds((h, w), seed=0)
    truth = G.scene_to_params(scene)
    render = jax.jit(lambda p: G.render_radiance(
        G.params_to_scene(p, scene), cam, rng, w, h, num_bounces=b, spp=spp,
        has_dielectric=False))
    target = render(truth)
    # Emission is what the loss is quadratic in: start from half of it.
    params = truth._replace(sphere_illum=truth.sphere_illum * 0.5,
                            plane_illum=truth.plane_illum * 0.5)
    vg = jax.jit(jax.value_and_grad(lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=b, spp=spp,
        backend="auto", has_dielectric=False)))
    losses = []
    for _ in range(steps):
        loss, g = vg(params)
        gs, gp = g.sphere_illum, g.plane_illum
        # Polyak step: exact line search for a quadratic whose minimum is 0.
        lr = loss / (jnp.sum(gs * gs) + jnp.sum(gp * gp))
        params = params._replace(sphere_illum=params.sphere_illum - lr * gs,
                                 plane_illum=params.plane_illum - lr * gp)
        losses.append(float(loss))
    check(np.isfinite(losses).all(), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return {"route": routes.fast_route("parity_grad"), "losses": losses}


def lane_shares(rng_a, rng_b, rad_a, rad_b, rtol=1e-5):
    import numpy as np

    rng_eq = (np.asarray(rng_a) == np.asarray(rng_b)).all(-1)
    close = np.isclose(np.asarray(rad_a), np.asarray(rad_b), rtol=rtol,
                       atol=1e-6).all(-1)
    return float(rng_eq.mean()), float(close.mean())


def _on_cpu(fn):
    """Run `fn()` with JAX's default device set to the host CPU: arrays
    it creates, and computations on them, stay on the CPU."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


def grad_lanes(w, h, spp, b, seed, rtol=1e-4, interpret=False):
    """Scene cotangents of the headline's loss, sum(image), from the
    Triton fwd+bwd kernel against XLA, lane by lane and in total.

    Per lane: the kernel's backward writes one partial table cotangent per
    program of `BWD_BLOCK` consecutive lanes; with the radiance cotangent
    restricted to lane j of every program, those partials are the
    cotangents of lane j alone.  `BWD_BLOCK` such calls, pulled back
    through the table packing, give each lane's [P] parameter cotangent.
    XLA's per-lane forward-mode Jacobian gives the same from the plain
    formulation.  A lane agrees if every entry is within `rtol` of XLA's,
    relative to the entry plus that parameter's 99th-percentile magnitude
    over lanes.

    Totals: `jax.grad` through the public path (`render_radiance`) on
    each route, over all lanes and over the agreeing lanes only (the
    others weighted 0).  A lane disagrees when its path passes a
    near-singular point (a sphere hit near tangency, a plane hit near
    grazing): there the derivative amplifies an ulp of difference in the
    forward values into a large one.  `interpret` runs the kernel in
    Pallas' interpreter (tests only).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.flatten_util import ravel_pytree

    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.models import world
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.ops import pallas_megakernel as PM
    from haskell_path_tracer.ops import pallas_megakernel_vjp as V
    from haskell_path_tracer.ops.rng import gen_seeds

    scene, cam = world.main_scene(), world.initial_camera()
    flat0, unravel = ravel_pytree(G.scene_to_params(scene))
    rng = gen_seeds((h, w), seed=seed)
    n, lanes = h * w, V.BWD_BLOCK

    def image(f, backend):
        return G.render_radiance(
            G.params_to_scene(unravel(f), scene), cam, rng, w, h,
            num_bounces=b, spp=spp, backend=backend, has_dielectric=False,
            interpret=interpret)

    # Per lane, from the kernel.
    table, gcols = PM._flat_table(scene)
    rays = primary_rays(cam, w, h)
    _, pull = jax.vjp(
        lambda f: PM._flat_table(G.params_to_scene(unravel(f), scene))[0],
        flat0)

    @jax.jit
    def lane_partials(j):
        on = (jnp.arange(n) % lanes == j).reshape(h, w, 1)
        g = jnp.broadcast_to(jnp.where(on, 1.0 / spp, 0.0), (h, w, 3))
        d_blocks, _, _ = V._bwd_call(
            table, gcols, rays.origin, rays.direction, rng, g, spp=spp,
            num_bounces=b, num_spheres=scene.spheres.count,
            num_prims=scene.num_primitives, has_dielectric=False,
            num_boxes=scene.boxes.count, num_triangles=scene.triangles.count,
            interpret=interpret)
        return jax.vmap(lambda t: pull(t)[0])(d_blocks)

    kern = np.stack([np.asarray(lane_partials(j)) for j in range(lanes)],
                    axis=1).reshape(-1, flat0.size)[:n].astype(np.float64)
    # Per lane, from XLA.
    jac = jax.jit(jax.jacfwd(lambda f: image(f, "xla")))(flat0)
    xla = np.asarray(jnp.sum(jac, axis=2).reshape(n, -1), np.float64)
    del jac

    mag = np.abs(xla)
    scale = np.array([np.quantile(c[c > 0], 0.99) if (c > 0).any() else 0.0
                      for c in mag.T])
    agree = (np.abs(kern - xla) <= rtol * (mag + scale)).all(-1)

    def totals(keep):
        wts = jnp.asarray(keep.reshape(h, w, 1), jnp.float32)
        return [np.asarray(jax.jit(jax.grad(
            lambda f, _b=backend: jnp.sum(image(f, _b) * wts)))(flat0))
            for backend in ("pallas", "xla")]

    def leaf_errs(a, ref):
        a, ref = unravel(jnp.asarray(a)), unravel(jnp.asarray(ref))
        out = {}
        for field in G.SceneParams._fields:
            x = np.asarray(getattr(ref, field), np.float64)
            if x.size:
                y = np.asarray(getattr(a, field), np.float64)
                out[field] = float(np.abs(y - x).max()
                                   / (np.abs(x).max() + 1e-30))
        return out

    k_all, x_all = totals(np.ones(n, bool))
    k_ok, x_ok = totals(agree)
    return {
        "lanes": n, "lane_agree_share": float(agree.mean()),
        "total_all_lanes": leaf_errs(k_all, x_all),
        "total_agreeing_lanes": leaf_errs(k_ok, x_ok),
        "xla_forward_vs_reverse_total": leaf_errs(xla.sum(0), x_all),
    }


def phase_kernels(w=512, h=512, b=8):
    import jax
    import numpy as np

    from haskell_path_tracer.models import world
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.ops.pallas_megakernel import trace_inline_pallas
    from haskell_path_tracer.ops.rng import gen_seeds
    from haskell_path_tracer.parity import oracle_np
    from haskell_path_tracer.render.integrator import trace_inline

    scene, cam = world.main_scene(), world.initial_camera()

    def xla_forward():
        # Everything built here, so that under `_on_cpu` it is all on the
        # CPU.
        s, c = world.main_scene(), world.initial_camera()
        rays = primary_rays(c, w, h)
        return jax.jit(lambda r: trace_inline(s, rays, r, b))(
            gen_seeds((h, w), seed=1))

    rng = gen_seeds((h, w), seed=1)
    tri = jax.jit(lambda r: trace_inline_pallas(
        scene, primary_rays(cam, w, h), r, num_bounces=b, spp=1))(rng)
    xla = xla_forward()
    xla_cpu = _on_cpu(xla_forward)
    o_np, d_np = oracle_np.primary_rays_np(cam, w, h)
    ora = oracle_np.trace_inline_np(scene, o_np, d_np, np.asarray(rng), b)
    rec = {}
    for name, (a, ref) in {"kernel_vs_xla": (tri, xla),
                           "kernel_vs_oracle": (tri, ora),
                           "xla_vs_oracle": (xla, ora),
                           "xla_gpu_vs_xla_cpu": (xla, xla_cpu)}.items():
        rng_eq, close = lane_shares(ref[1], a[1], ref[0], a[0])
        rec[name] = {"rng_bit_equal": rng_eq, "radiance_rtol1e-5": close}
        check(rng_eq >= MIN_LANE_SHARE and close >= MIN_LANE_SHARE,
              f"forward {name}: {rng_eq}, {close}")

    # Fwd+bwd against jax.grad of XLA: per lane at the headline's 64 spp,
    # and every leaf's total over the agreeing lanes at 4 spp (at 64 spp
    # lanes near a singular point that still pass the lane bound add up,
    # in totals that cancel, beyond it: PERF.md, "H100").
    for spp in (64, 4):
        g = grad_lanes(w, h, spp, b, seed=0, rtol=GRAD_RTOL)
        rec[f"grad_{spp}spp"] = g
        check(g["lane_agree_share"] >= MIN_LANE_SHARE,
              f"{spp} spp: cotangents agree on {g['lane_agree_share']} of "
              "lanes")
    worst = max(rec["grad_4spp"]["total_agreeing_lanes"].items(),
                key=lambda kv: kv[1])
    check(worst[1] <= GRAD_RTOL, f"4 spp total cotangent {worst}")
    return rec


def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_chip.py")])
    check(rc == 0, f"chip tests exited {rc}")
    return {"pytest_exit": int(rc)}


def phase_sharded(w=800, h=600, gw=512, gh=512):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.models import world
    from haskell_path_tracer.ops.rng import gen_seeds
    from haskell_path_tracer.parallel import mesh as M
    from haskell_path_tracer.parallel.shard import (
        place_accumulator,
        render_sharded,
        train_step_sharded,
    )
    from haskell_path_tracer.render.integrator import make_accumulator

    devices = jax.devices()
    check(len(devices) >= 4, f"--chips 4 needs 4 GPUs, found {len(devices)}")
    meshes = {n: M.make_mesh(n_tile=n, devices=devices[:n]) for n in (4, 1)}
    scene, cam = world.main_scene(), world.initial_camera()
    rec = {}
    for algo, spp, bounces in (("inline", 4, 15), ("physical", 2, 8),
                               ("split", 2, 8)):
        out = {}
        for n, mesh in meshes.items():
            acc = place_accumulator(make_accumulator(w, h, seed=0), mesh)
            step = jax.jit(lambda s, c, a, _m=mesh, _a=algo: render_sharded(
                s, c, a, spp=spp, mesh=_m, num_bounces=bounces,
                algorithm=_a))
            out[n] = step(scene, cam, acc)
        rng_eq, close = lane_shares(out[1].rng, out[4].rng,
                                    out[1].color, out[4].color)
        check(np.isfinite(np.asarray(out[4].color)).all(), f"{algo}: NaN")
        check(rng_eq >= MIN_LANE_SHARE and close >= MIN_LANE_SHARE,
              f"render_sharded {algo}: {rng_eq}, {close}")
        rec[algo] = {"rng_bit_equal": rng_eq, "radiance_rtol1e-5": close}

    params = G.scene_to_params(scene)
    rng = gen_seeds((gh, gw), seed=2)
    target = jnp.full((gh, gw, 3), 0.1, jnp.float32)
    out = {}
    for n, mesh in meshes.items():
        step = jax.jit(lambda p, _m=mesh: train_step_sharded(
            p, scene, cam, target, rng, _m, num_bounces=8, lr=1e-3))
        out[n] = step(params)
    l1, l4 = float(out[1][1]), float(out[4][1])
    check(np.isfinite(l4) and abs(l4 - l1) <= 1e-5 * abs(l1),
          f"train_step_sharded loss {l4} vs {l1}")
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(out[4][0]),
                    jax.tree_util.tree_leaves(out[1][0])):
        a, b = np.asarray(a), np.asarray(b)
        if b.size:
            worst = max(worst, float(np.abs(a - b).max()
                                     / (np.abs(b).max() + 1e-30)))
    # The psum over 4 tiles reorders the f32 gradient sum.
    check(worst <= 1e-4, f"train_step_sharded params differ: {worst}")
    rec["train_step"] = {"loss_1": l1, "loss_4": l4,
                         "params_max_norm_err": worst}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from haskell_path_tracer.utils import compile_cache

    compile_cache.configure()
    card = phase_device()
    emit({"phase": "device", **card})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.chips == 4:
            phases = [("sharded", phase_sharded)]
        else:
            phases = [("cli", lambda: phase_cli(tmp)),
                      ("gradient", phase_gradient),
                      ("kernels", phase_kernels),
                      ("tests", phase_tests)]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                rec = fn()
            except Exception as e:  # report the failed phase, then stop
                emit({"phase": name, "ok": False,
                      "error": f"{type(e).__name__}: {e}"[:2000]})
                return 1
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **rec})
    print("\n".join(card["cards"]), flush=True)
    emit({"ok": True, "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": args.chips}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
