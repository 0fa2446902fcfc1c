"""Primary ray generation from the pinhole camera.

Behavioral parity with `primaryRays`
(upstream src/Scene/Trace.hs:205-262) including its quirks:

  * the virtual screen plane sits at distance `1/tan(fov/2)` from the camera
    and has half-width `tan * dist == 1` (Trace.hs:210-219);
  * screen space runs x in [-1, 1) left->right and y in (-1, 1] top->bottom;
    the Y flip is folded into a negated screen height, exactly like
    `screenSize` (upstream src/Util.hs:198-200);
  * `rightOffset` is *divided* by the half-width and `topOffset` by the
    aspect ratio (Trace.hs:240-241) — reproduced verbatim.

Unlike the reference — which bakes the 800x600 pixel-coordinate matrix into
the compiled kernel (upstream app/Main.hs:154,190) — resolution is a
static jit argument here, and the pixel grid is generated on device with
`broadcasted_iota` (never shipped over PCIe).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import linalg
from .objects import Camera, Rays


def camera_basis(camera: Camera):
    """The virtual-plane frame: (plane_center, top_offset, right_offset).

    Trace.hs:234-242.
    """
    fov = camera.fov.astype(jnp.float32)
    screen_angle = (fov * jnp.pi / 180.0) / 2.0
    screen_distance = 1.0 / jnp.tan(screen_angle)
    screen_half_width = jnp.tan(screen_angle) * screen_distance  # == 1.0

    c_dir = linalg.angles_to_direction(camera.rotation)
    center = camera.position + c_dir * screen_distance
    center_offset = center - camera.position
    right_offset = (
        linalg.normalize_safe(linalg.cross(center_offset, linalg.UP))
        / screen_half_width
    )
    return center, c_dir, right_offset


def primary_rays(
    camera: Camera,
    width: int,
    height: int,
    row_offset=0,
    full_height: int | None = None,
) -> Rays:
    """Generate one primary ray per pixel.  Returns Rays with
    origin/direction of shape [height, width, 3].

    Trace.hs:244-262: raster -> screen space -> point on the virtual plane ->
    normalized direction from the camera position.

    For image-tile sharding, a device generates only its row block:
    `height` is the block height, `row_offset` the block's first global row
    (may be traced, e.g. `axis_index * block_h` inside shard_map), and
    `full_height` the global image height the screen-space mapping is
    normalized against.
    """
    center, c_dir, right_offset = camera_basis(camera)
    fh = height if full_height is None else full_height
    aspect = jnp.float32(width) / jnp.float32(fh)
    top_offset = linalg.cross(c_dir, right_offset) / aspect

    # rasterPos / screenSize * 2 + (-1, 1), screenSize = (W, -H)
    # (Util.hs:198-200) — pixel (x, y) with y = row index from the top.
    xs = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    ys = ys + jnp.asarray(row_offset, jnp.float32)
    screen_x = xs / jnp.float32(width) * 2.0 - 1.0
    screen_y = ys / jnp.float32(-fh) * 2.0 + 1.0

    virtual_point = (
        center
        + right_offset * screen_x[..., None]
        + top_offset * screen_y[..., None]
    )
    ray_dir = linalg.normalize_safe(virtual_point - camera.position)
    origin = jnp.broadcast_to(camera.position, ray_dir.shape)
    return Rays(origin=origin, direction=ray_dir)
