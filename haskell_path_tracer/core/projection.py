"""View / projection matrices (lifted ``Linear.Projection`` parity).

Array-native counterpart of the reference's
``upstream src/Data/Array/Accelerate/Linear/Projection.hs`` — its
``Exp``-lifted copies of the ``linear`` package's projection functions
(``lookAt`` :22-38, ``lookAtScratch`` :43-57, ``perspective`` :60-82,
``infinitePerspective`` :86-103, ``inverseInfinitePerspective`` :105-123).

Like the reference, nothing on the render path calls these — primary rays
use the virtual-plane construction in ``models/camera.py`` (parity with
``upstream src/Scene/Trace.hs:234-262``) — but they are part of the
reference's public surface and are kept for debugging, rasterized previews,
and any client that wants a classic camera matrix.

All functions are batched: scalar inputs may carry arbitrary leading
dimensions and the result is ``[..., 4, 4]`` with the reference's row
layout (row-vector ``M44``: ``V4 (V4 a)`` rows).
"""

from __future__ import annotations

import jax.numpy as jnp

from .linalg import cross, dot, normalize


def _rows(*rows: jnp.ndarray) -> jnp.ndarray:
    """Stack four [..., 4] rows into [..., 4, 4]."""
    return jnp.stack(rows, axis=-2)


def _row(a, b, c, d) -> jnp.ndarray:
    parts = [jnp.asarray(v, jnp.float32) for v in (a, b, c, d)]
    parts = jnp.broadcast_arrays(*parts)
    return jnp.stack(parts, axis=-1)


def look_at(
    eye: jnp.ndarray, center: jnp.ndarray, up: jnp.ndarray
) -> jnp.ndarray:
    """Build a look-at view matrix.

    Parity with ``Projection.hs:22-38`` (itself `Linear.Projection.lookAt`):
    rows are the camera's right / up / negated-forward axes with the
    translation terms in the fourth column.
    """
    za = normalize(center - eye)
    xa = normalize(cross(za, up))
    ya = cross(xa, za)
    xd = -dot(xa, eye)
    yd = -dot(ya, eye)
    zd = dot(za, eye)
    return _rows(
        _row(xa[..., 0], xa[..., 1], xa[..., 2], xd),
        _row(ya[..., 0], ya[..., 1], ya[..., 2], yd),
        _row(-za[..., 0], -za[..., 1], -za[..., 2], zd),
        _row(
            jnp.zeros_like(xd), jnp.zeros_like(xd), jnp.zeros_like(xd),
            jnp.ones_like(xd),
        ),
    )


def look_at_scratch(
    from_: jnp.ndarray, to: jnp.ndarray, tmp: jnp.ndarray
) -> jnp.ndarray:
    """The scratchapixel look-at variant kept by the reference for
    debugging (``Projection.hs:43-57``): a camera-to-world basis matrix
    with the eye position in the last row and no translation column."""
    forward = normalize(from_ - to)
    right = cross(normalize(tmp), forward)
    up = cross(forward, right)
    zero = jnp.zeros_like(from_[..., 0])
    return _rows(
        _row(right[..., 0], right[..., 1], right[..., 2], zero),
        _row(up[..., 0], up[..., 1], up[..., 2], zero),
        _row(forward[..., 0], forward[..., 1], forward[..., 2], zero),
        _row(from_[..., 0], from_[..., 1], from_[..., 2], zero),
    )


def perspective(
    fovy: jnp.ndarray,
    aspect: jnp.ndarray,
    near: jnp.ndarray,
    far: jnp.ndarray,
) -> jnp.ndarray:
    """Symmetric perspective frustum matrix.

    Parity with ``Projection.hs:60-82`` including its numerically improved
    ``w = 1 / (0.5/far - 0.5/near)`` form (the comment at :81 notes it cuts
    13 bits of error to 0.17 vs the textbook ``-(2*far*near)/(far-near)``).
    """
    fovy = jnp.asarray(fovy, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    tan_half = jnp.tan(fovy / 2)
    x = 1 / (aspect * tan_half)
    y = 1 / tan_half
    z = -(far + near) / (far - near)
    w = 1 / (0.5 / far - 0.5 / near)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    return _rows(
        _row(x, zero, zero, zero),
        _row(zero, y, zero, zero),
        _row(zero, zero, z, w),
        _row(zero, zero, -one, zero),
    )


def infinite_perspective(
    fovy: jnp.ndarray, aspect: jnp.ndarray, near: jnp.ndarray
) -> jnp.ndarray:
    """Perspective frustum with the far plane at infinity
    (``Projection.hs:86-103``)."""
    fovy = jnp.asarray(fovy, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    t = near * jnp.tan(fovy / 2)
    b = -t
    left = b * aspect
    r = t * aspect
    x = (2 * near) / (r - left)
    y = (2 * near) / (t - b)
    w = -2 * near
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    return _rows(
        _row(x, zero, zero, zero),
        _row(zero, y, zero, zero),
        _row(zero, zero, -one, w),
        _row(zero, zero, -one, zero),
    )


def inverse_infinite_perspective(
    fovy: jnp.ndarray, aspect: jnp.ndarray, near: jnp.ndarray
) -> jnp.ndarray:
    """Closed-form inverse of :func:`infinite_perspective`
    (``Projection.hs:105-123``)."""
    fovy = jnp.asarray(fovy, jnp.float32)
    aspect = jnp.asarray(aspect, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    t = near * jnp.tan(fovy / 2)
    b = -t
    left = b * aspect
    r = t * aspect
    hrn = 0.5 / near
    rx = (r - left) * hrn
    ry = (t - b) * hrn
    rw = -hrn
    zero = jnp.zeros_like(rx)
    one = jnp.ones_like(rx)
    return _rows(
        _row(rx, zero, zero, zero),
        _row(zero, ry, zero, zero),
        _row(zero, zero, zero, -one),
        _row(zero, zero, rw, -rw),
    )
