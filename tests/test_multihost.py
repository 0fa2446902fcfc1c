"""REAL multi-process `jax.distributed` execution.

Launches 2 separate OS processes, each with 2 forced CPU devices, joined
through `jax.distributed.initialize` + gloo collectives — the same
bring-up path a multi-host cluster uses (parallel/multihost.py), with the gradient
`psum` genuinely crossing a process boundary.  Asserts:

  * both workers complete and see a 4-device global mesh;
  * `local_row_block`'s contiguous-device-order assumption holds (each
    worker checks its addressable shard rows against the claimed block);
  * the assembled tile-sharded render equals the single-process render
    bit-for-bit (rng) / to fp tolerance (color);
  * the distributed train step's loss and updated params match the
    single-device `value_and_grad` reference on every process.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

from haskell_path_tracer.diff import grad as G
from haskell_path_tracer.models import world
from haskell_path_tracer.ops.rng import gen_seeds
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_batch_inline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")
W, H, SPP, B = 32, 24, 2, 3
NPROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    # 2 local devices per process -> 4 global devices.
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=2"]
    )
    env.pop("JAX_NUM_PROCESSES", None)
    # `python tests/multihost_worker.py` puts tests/ (not the repo root)
    # on sys.path; make the package importable.
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_process_distributed_render_and_train(tmp_path):
    port = _free_port()
    env = _worker_env()
    outs = [tmp_path / f"w{i}.npz" for i in range(NPROC)]
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                WORKER,
                str(i),
                str(NPROC),
                f"localhost:{port}",
                str(outs[i]),
            ],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(NPROC)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    data = [np.load(o) for o in outs]

    # Workers partition the rows contiguously and completely.
    blocks = sorted(data, key=lambda d: int(d["start"]))
    assert int(blocks[0]["start"]) == 0
    assert int(blocks[0]["stop"]) == int(blocks[1]["start"])
    assert int(blocks[1]["stop"]) == H

    color = np.concatenate([d["color"] for d in blocks], axis=0)
    rng = np.concatenate([d["rng"] for d in blocks], axis=0)

    # Single-process reference (this test process: plain single device).
    scene, cam = world.main_scene(), world.initial_camera()
    ref = render_batch_inline(
        scene, cam, make_accumulator(W, H, seed=4), spp=SPP, num_bounces=B
    )
    np.testing.assert_array_equal(rng, np.asarray(ref.rng))
    np.testing.assert_allclose(
        color, np.asarray(ref.color), rtol=1e-6, atol=1e-6
    )

    # Train step: loss and updated params match the single-device
    # reference on EVERY process (psum crossed the process boundary).
    params = G.scene_to_params(scene)
    rng9 = gen_seeds((H, W), seed=9)
    target = np.asarray(G.render_radiance(scene, cam, rng9, W, H, 3)) * 0.5
    loss_fn = lambda p: G.image_loss(
        p, scene, cam, target, rng9, num_bounces=3
    )
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref_new = jax.tree_util.tree_map(
        lambda p, g: p - 0.1 * g, params, ref_grads
    )
    ref_leaves = jax.tree_util.tree_leaves(ref_new)
    for d in data:
        np.testing.assert_allclose(
            float(d["loss"]), float(ref_loss), rtol=1e-5
        )
        for i, leaf in enumerate(ref_leaves):
            np.testing.assert_allclose(
                d[f"param{i}"],
                np.asarray(leaf),
                rtol=1e-4,
                atol=1e-6,
                err_msg=f"param leaf {i}",
            )
