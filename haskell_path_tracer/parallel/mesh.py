"""Device mesh construction for sharded rendering.

The reference has zero device-level distribution (SURVEY.md §2.3: one
process, one device).  The framework's parallelism axes:

  * `tile` — image rows sharded across chips.  Forward rendering is then
    embarrassingly parallel: every chip owns its pixels' rays for the whole
    bounce loop (the scene is tiny and replicated, so no cross-chip traffic
    during bounces — SURVEY.md §5 "long-context" analog);
  * `sample` — sample batches sharded across chips; chips render the same
    tile with different RNG streams and their radiance sums `psum` at the
    end.  Used when more chips than useful tiles.

Collectives appear only for (i) scene-parameter gradient reduction in
inverse rendering and (ii) sample-axis radiance reduction — both `psum`
over ICI.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def make_mesh(
    n_tile: Optional[int] = None,
    n_sample: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (tile, sample) mesh.  Defaults to all devices on the tile
    axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tile is None:
        n_tile = len(devices) // n_sample
    assert n_tile * n_sample == len(devices), (
        f"mesh {n_tile}x{n_sample} != {len(devices)} devices"
    )
    dev_array = np.asarray(devices).reshape(n_tile, n_sample)
    return Mesh(dev_array, (TILE_AXIS, SAMPLE_AXIS))


def accumulator_sharding(mesh: Mesh) -> NamedSharding:
    """Row-sharded image state: color [H,W,3] and rng [H,W,4] split over
    `tile`, replicated over `sample`."""
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
