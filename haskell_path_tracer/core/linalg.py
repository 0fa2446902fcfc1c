"""Vector / quaternion math on stacked ``[..., 3]`` arrays.

Array-native reformulation of the reference's vector layer
(``upstream src/Util.hs:46-108`` plus the ``linear`` package ops it
imports).  Everything here operates on *structure-of-arrays* data: a "V3" is
any array whose trailing axis has length 3, so every function is natively
batched over arbitrary leading (pixel / ray / sample) dimensions and maps
straight onto vector lanes with no vmap overhead.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# World basis vectors (upstream src/Util.hs:96-102): the camera looks
# down -Z when unrotated; +Y is up.  Host numpy (not jnp): a module-level
# device array would initialize the XLA backend at import time, which breaks
# `jax.distributed.initialize` (multihost bring-up must run first); jnp ops
# convert numpy operands for free.
FORWARD = np.array([0.0, 0.0, -1.0], dtype=np.float32)
UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)

# `linear`'s `Epsilon Float` threshold: nearZero a = abs a <= 1e-6.  For V3 the
# instance is nearZero . quadrance, i.e. |v|^2 <= 1e-6 (see `nearZero` calls at
# upstream src/Scene/Trace.hs:331,364).
NEAR_ZERO_EPS = 1e-6


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis. Keeps leading dims."""
    return jnp.sum(a * b, axis=-1)


def quadrance(v: jnp.ndarray) -> jnp.ndarray:
    """Squared length |v|^2 (linear's `quadrance`)."""
    return jnp.sum(v * v, axis=-1)


def norm(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(quadrance(v))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize over the trailing axis.

    Matches `linear`'s `normalize` (no epsilon guard: zero vectors produce
    NaN/Inf exactly as the Haskell reference would).  Use `normalize_safe` on
    the differentiable path.
    """
    return v / norm(v)[..., None]


def normalize_safe(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Gradient-safe normalize: clamps |v| away from 0 so VJPs stay finite."""
    n = jnp.maximum(norm(v), eps)
    return v / n[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """`nearZero` for V3 Float: quadrance <= 1e-6 (linear's Epsilon)."""
    return quadrance(v) <= NEAR_ZERO_EPS


# ---------------------------------------------------------------------------
# Quaternions.  Layout [..., 4] = (w, x, y, z), matching linear's
# `Quaternion w (V3 x y z)`.
# ---------------------------------------------------------------------------


def angles_to_quaternion(angles: jnp.ndarray) -> jnp.ndarray:
    """Euler (roll, pitch, yaw) -> quaternion.

    Exact transliteration of the wikipedia formula the reference uses
    (upstream src/Util.hs:55-67).  `angles` is [..., 3] =
    (roll, pitch, yaw); result is [..., 4] = (w, x, y, z).
    """
    roll, pitch, yaw = angles[..., 0], angles[..., 1], angles[..., 2]
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = sy * cp * sr + cy * sp * cr
    z = sy * cp * cr - cy * sp * sr
    return jnp.stack([w, x, y, z], axis=-1)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) `v` [...,3] by quaternion(s) `q` [...,4].

    Matches linear's `rotate` (q * (0,v) * conj q, imaginary part), which for
    the unit quaternions produced by `angles_to_quaternion` is a rotation.
    Implemented via the standard 15-mul expansion (cheaper elementwise than two
    quaternion products).
    """
    w = q[..., 0:1]
    u = q[..., 1:4]
    # rotate(q, v) = v + 2*cross(u, cross(u, v) + w*v)   (unit q)
    t = cross(u, v) * 2.0
    return v + w * t + cross(u, t)


def angles_to_direction(angles: jnp.ndarray) -> jnp.ndarray:
    """Euler camera rotation -> looking direction.

    Parity with upstream src/Util.hs:48-50 (rotate the world FORWARD
    vector by the camera quaternion).
    """
    return quat_rotate(angles_to_quaternion(angles), FORWARD)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction `d` about normal `n`.

    Parity with the Glossy branch at upstream src/Scene/Trace.hs:421-422.
    """
    return d - 2.0 * dot(d, n)[..., None] * n
