"""View/projection matrix parity (reference Projection.hs behaviors).

Pins the contract of /root/reference/src/Data/Array/Accelerate/Linear/
Projection.hs: look_at agrees with the classic gluLookAt construction,
perspective with the GL frustum matrix (including the reference's improved
``w`` term), and inverse_infinite_perspective is the exact matrix inverse of
infinite_perspective.
"""

import numpy as np
import jax.numpy as jnp

from haskell_path_tracer.core import projection as P


def _apply(m, v):
    """Row-major M44 applied to a homogeneous point (matches linear's
    ``m !* v`` for the reference's row layout)."""
    return np.asarray(m) @ np.asarray(v)


def test_look_at_maps_eye_to_origin():
    eye = jnp.asarray([1.0, 2.0, 3.0])
    center = jnp.asarray([0.0, 0.0, 0.0])
    up = jnp.asarray([0.0, 1.0, 0.0])
    m = P.look_at(eye, center, up)
    out = _apply(m, [1.0, 2.0, 3.0, 1.0])
    np.testing.assert_allclose(out[:3], 0.0, atol=1e-6)
    assert out[3] == 1.0


def test_look_at_maps_view_direction_to_minus_z():
    eye = jnp.asarray([1.0, 2.0, 3.0])
    center = jnp.asarray([-2.0, 0.5, 7.0])
    up = jnp.asarray([0.0, 1.0, 0.0])
    m = P.look_at(eye, center, up)
    # The point being looked at lands on the -Z axis at distance |center-eye|.
    out = _apply(m, [-2.0, 0.5, 7.0, 1.0])
    dist = np.linalg.norm(np.asarray(center) - np.asarray(eye))
    np.testing.assert_allclose(out[:2], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[2], -dist, rtol=1e-5)


def test_look_at_rows_are_orthonormal():
    m = np.asarray(
        P.look_at(
            jnp.asarray([4.0, -1.0, 2.0]),
            jnp.asarray([0.0, 0.0, -5.0]),
            jnp.asarray([0.0, 1.0, 0.0]),
        )
    )
    basis = m[:3, :3]
    np.testing.assert_allclose(basis @ basis.T, np.eye(3), atol=1e-6)


def test_look_at_scratch_basis():
    from_ = jnp.asarray([2.0, 1.0, 5.0])
    to = jnp.asarray([0.0, 0.0, 0.0])
    tmp = jnp.asarray([0.0, 1.0, 0.0])
    m = np.asarray(P.look_at_scratch(from_, to, tmp))
    fwd = np.asarray(from_) / np.linalg.norm(np.asarray(from_))
    np.testing.assert_allclose(m[2, :3], fwd, rtol=1e-6)
    np.testing.assert_allclose(m[3, :3], np.asarray(from_), rtol=1e-6)
    # Faithful to Projection.hs:49-57: right = normalize(tmp) x forward and
    # up = forward x right are NOT re-normalized, so rows 0/1 carry a
    # |sin(angle(tmp, forward))| scale; rows are mutually orthogonal.
    gram = m[:3, :3] @ m[:3, :3].T
    np.testing.assert_allclose(
        gram - np.diag(np.diag(gram)), np.zeros((3, 3)), atol=1e-6
    )
    s2 = 1.0 - float(fwd @ np.asarray([0.0, 1.0, 0.0])) ** 2
    np.testing.assert_allclose(np.diag(gram), [s2, s2, 1.0], rtol=1e-5)
    np.testing.assert_allclose(m[:, 3], 0.0, atol=0)


def test_perspective_matches_gl_frustum():
    fovy, aspect, near, far = 1.2, 4.0 / 3.0, 0.1, 100.0
    m = np.asarray(P.perspective(fovy, aspect, near, far))
    th = np.tan(fovy / 2)
    expect = np.zeros((4, 4), np.float32)
    expect[0, 0] = 1 / (aspect * th)
    expect[1, 1] = 1 / th
    expect[2, 2] = -(far + near) / (far - near)
    expect[2, 3] = -(2 * far * near) / (far - near)
    expect[3, 2] = -1
    np.testing.assert_allclose(m, expect, rtol=1e-4)


def test_perspective_maps_near_far_to_clip_planes():
    fovy, aspect, near, far = 0.9, 1.5, 0.5, 50.0
    m = P.perspective(fovy, aspect, near, far)
    on = _apply(m, [0.0, 0.0, -near, 1.0])
    of = _apply(m, [0.0, 0.0, -far, 1.0])
    np.testing.assert_allclose(on[2] / on[3], -1.0, rtol=1e-4)
    np.testing.assert_allclose(of[2] / of[3], 1.0, rtol=1e-4)


def test_infinite_perspective_far_limit():
    fovy, aspect, near = 1.0, 1.0, 0.25
    m = P.infinite_perspective(fovy, aspect, near)
    on = _apply(m, [0.0, 0.0, -near, 1.0])
    np.testing.assert_allclose(on[2] / on[3], -1.0, rtol=1e-5)
    # z -> -inf approaches NDC depth 1 from below.
    ofar = _apply(m, [0.0, 0.0, -1e6, 1.0])
    np.testing.assert_allclose(ofar[2] / ofar[3], 1.0, rtol=1e-3)


def test_inverse_infinite_perspective_is_inverse():
    fovy, aspect, near = 1.1, 16.0 / 9.0, 0.1
    m = np.asarray(P.infinite_perspective(fovy, aspect, near), np.float64)
    mi = np.asarray(
        P.inverse_infinite_perspective(fovy, aspect, near), np.float64
    )
    np.testing.assert_allclose(m @ mi, np.eye(4), atol=1e-5)
    np.testing.assert_allclose(mi @ m, np.eye(4), atol=1e-5)


def test_batched_broadcasting():
    eyes = jnp.asarray(np.random.default_rng(0).normal(size=(5, 3)), jnp.float32)
    center = jnp.zeros((5, 3), jnp.float32)
    up = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), (5, 3))
    m = P.look_at(eyes, center, up)
    assert m.shape == (5, 4, 4)
    single = P.look_at(eyes[2], center[2], up[2])
    np.testing.assert_allclose(
        np.asarray(m[2]), np.asarray(single), atol=1e-6
    )

    fovy = jnp.full((7,), 1.0, jnp.float32)
    m2 = P.perspective(fovy, 1.0, 0.1, 10.0)
    assert m2.shape == (7, 4, 4)
