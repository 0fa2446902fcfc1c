"""Worker process for the REAL multi-process `jax.distributed` test.

Launched by tests/test_multihost.py as

    python tests/multihost_worker.py <process_id> <num_processes> \
        <coordinator_addr> <out.npz>

with a clean environment (JAX_PLATFORMS=cpu, 2 forced host devices per
process, gloo CPU collectives).  Each process owns 2
of the 2*num_processes global devices; the mesh, shardings, and compiled
programs are identical to the single-process path (parallel/shard.py) —
only the collectives now actually cross a process boundary, which is the
thing the virtual-device tests cannot exercise.

The reference never crosses a process boundary at all (SURVEY.md §2.3);
this is the framework's `jax.distributed` bring-up path
(parallel/multihost.py) executed for real.
"""

from __future__ import annotations

import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coord, out_path = sys.argv[3], sys.argv[4]

    # Must run before any backend initialization.
    from haskell_path_tracer.parallel.multihost import (
        host_to_global,
        initialize_distributed,
        local_row_block,
        replicate_tree,
    )

    assert initialize_distributed(coord, nproc, pid)

    import jax
    import numpy as np

    from haskell_path_tracer.diff import grad as G
    from haskell_path_tracer.models import world
    from haskell_path_tracer.models.objects import Accumulator
    from haskell_path_tracer.ops.rng import gen_seeds
    from haskell_path_tracer.parallel import mesh as M
    from haskell_path_tracer.parallel.shard import (
        render_sharded,
        train_step_sharded,
    )
    from haskell_path_tracer.render.integrator import make_accumulator

    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid

    W, H, SPP, B = 32, 24, 2, 3
    scene, cam = world.main_scene(), world.initial_camera()
    mesh = M.make_mesh()  # all global devices on the tile axis
    n_tile = mesh.shape[M.TILE_AXIS]
    sh = M.accumulator_sharding(mesh)
    rep = M.replicated(mesh)

    glob = host_to_global
    scene_g = replicate_tree(scene, mesh)
    cam_g = replicate_tree(cam, mesh)

    # --- sharded progressive render across processes ---------------------
    host_acc = make_accumulator(W, H, seed=4)
    acc = Accumulator(
        color=glob(host_acc.color, sh),
        rng=glob(host_acc.rng, sh),
        iterations=glob(host_acc.iterations, rep),
    )
    out = render_sharded(scene_g, cam_g, acc, spp=SPP, mesh=mesh, num_bounces=B)
    jax.block_until_ready(out)

    # local_row_block's contiguity contract: the rows this process actually
    # addresses are exactly [start, stop).
    start, stop = local_row_block(H, n_tile)

    def collect(arr, width, ch, dtype):
        rows = set()
        block = np.zeros((stop - start, width, ch), dtype)
        for s_ in arr.addressable_shards:
            r = s_.index[0]
            r0 = r.start or 0
            r1 = H if r.stop is None else r.stop
            rows.update(range(r0, r1))
            block[r0 - start : r1 - start] = np.asarray(s_.data)
        assert rows == set(range(start, stop)), (sorted(rows), start, stop)
        return block

    color_block = collect(out.color, W, 3, np.float32)
    rng_block = collect(out.rng, W, 4, np.uint32)

    # --- sharded inverse-rendering step (grad psum over DCN-like boundary)
    params = replicate_tree(G.scene_to_params(scene), mesh)
    rng = gen_seeds((H, W), seed=9)
    target = np.asarray(G.render_radiance(scene, cam, rng, W, H, 3)) * 0.5
    new_params, loss = train_step_sharded(
        params,
        scene_g,
        cam_g,
        glob(target, sh),
        glob(rng, sh),
        mesh,
        num_bounces=3,
        lr=0.1,
    )
    jax.block_until_ready((new_params, loss))

    leaves = jax.tree_util.tree_leaves(new_params)
    np.savez(
        out_path,
        start=start,
        stop=stop,
        color=color_block,
        rng=rng_block,
        loss=np.asarray(loss.addressable_shards[0].data),
        **{
            f"param{i}": np.asarray(leaf.addressable_shards[0].data)
            for i, leaf in enumerate(leaves)
        },
    )
    print(f"worker {pid}: ok rows [{start}, {stop})", flush=True)


if __name__ == "__main__":
    main()
