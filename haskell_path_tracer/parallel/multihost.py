"""Multi-host bring-up helpers.

The reference never crosses a process boundary (SURVEY.md §2.3).  Scaling
past one host uses the standard JAX recipe: `jax.distributed.initialize`
on every host, then meshes spanning `jax.devices()` (all chips on all
hosts).  Collectives ride NVLink within a host and the network across
hosts — placement is XLA's job once the mesh and shardings are declared.

Testing without a cluster: force N virtual CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=N`, see tests/conftest.py)
— the sharding programs compile and run unchanged.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize multi-host JAX if configured; no-op on a single host.

    Reads the standard env vars (set by cluster launchers) when arguments
    are omitted.  Returns True if distributed mode is active.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def local_row_block(full_height: int, n_tile: int):
    """This process's row range under tile sharding — used by the host
    driver to assemble/checkpoint only addressable shards.

    The contiguous-device-order assumption (process p owns rows
    [p*local, (p+1)*local)) is asserted against the actual addressable
    shard indices by tests/multihost_worker.py."""
    idx = jax.process_index()
    per = full_height // n_tile
    # Each process addresses its local devices' tiles; with contiguous
    # device order, process p owns rows [p*local, (p+1)*local).
    local_tiles = jax.local_device_count()
    start = idx * local_tiles * per
    return start, start + local_tiles * per


def host_to_global(x, sharding):
    """Host value -> global `jax.Array` under `sharding`.

    Works in multi-process mode where `jax.device_put` cannot address
    remote shards: every process supplies its own addressable shards via
    `make_array_from_callback`.  Host data must be identical on all
    processes (deterministic seeding guarantees this for accumulators)."""
    import numpy as np

    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def replicate_tree(tree, mesh):
    """Replicate every leaf of a pytree across `mesh` as global arrays
    (multi-process-safe `jax.device_put(tree, P())`)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: host_to_global(x, rep), tree)
