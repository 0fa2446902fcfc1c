"""Camera interaction semantics from the reference's input loop.

Host-side camera controller reproducing upstream app/Main.hs:
  * WASD/Ctrl/Space translation deltas are accumulated, normalized, scaled
    by `movementSpeed * elapsed` with a 4x shift-sprint factor
    (Main.hs:106-108, 268-270, 296-301, 310-312);
  * the translation is applied in the camera's rotated frame
    (`translate`, upstream src/Util.hs:83-86);
  * mouselook adds `(dy, dx, 0) * -0.001` to the Euler rotation
    (Main.hs:284-292, 456-457);
  * the roll (slot 0) is clamped to +-(pi/2 - 0.001) (Main.hs:255-259);
  * any change invalidates the progressive accumulator (Main.hs:305-321) —
    the caller resets it while keeping the same compiled render function.

There is no SDL window on a headless accelerator host; this module is pure state arithmetic,
used by the offline animation driver and (optionally) a local viewer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import linalg
from ..models.objects import Camera

MOVEMENT_SPEED = 3.0  # Main.hs:107-108
MOUSE_SENSITIVITY = -0.001  # adjustSensitivity, Main.hs:456-457
ROLL_LIMIT = np.pi / 2 - 0.001  # Main.hs:255-259


def clamp_roll(rotation: np.ndarray) -> np.ndarray:
    out = np.asarray(rotation, np.float32).copy()
    out[0] = min(ROLL_LIMIT, max(-ROLL_LIMIT, float(out[0])))
    return out


def _quat_np(angles):
    roll, pitch, yaw = angles
    cy, sy = np.cos(yaw * 0.5), np.sin(yaw * 0.5)
    cp, sp = np.cos(pitch * 0.5), np.sin(pitch * 0.5)
    cr, sr = np.cos(roll * 0.5), np.sin(roll * 0.5)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            sy * cp * sr + cy * sp * cr,
            sy * cp * cr - cy * sp * sr,
        ],
        np.float32,
    )


def _rotate_np(q, v):
    w, u = q[0], q[1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def move_camera(
    camera: Camera,
    translation_delta,
    rotation_delta,
    elapsed: float = 1.0 / 60.0,
    sprint: bool = False,
) -> Camera:
    """Apply one frame of input.  `translation_delta` is the raw WASD axis
    sum (camera-local), `rotation_delta` the raw mouse (dy, dx, 0) pixels.

    Returns the new camera; the caller resets the accumulator if it
    changed.
    """
    t = np.asarray(translation_delta, np.float32)
    r = np.asarray(rotation_delta, np.float32) * MOUSE_SENSITIVITY

    rotation = np.asarray(camera.rotation, np.float32) + r
    rotation = clamp_roll(rotation)

    position = np.asarray(camera.position, np.float32)
    norm = float(np.linalg.norm(t))
    if norm > 0:
        distance = MOVEMENT_SPEED * elapsed * (1.0 if sprint else 0.25)
        world_delta = _rotate_np(_quat_np(rotation), t / norm * distance)
        position = position + world_delta

    return Camera.create(position, rotation, float(np.asarray(camera.fov)))
