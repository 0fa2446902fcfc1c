"""Vector/quaternion math tests (coverage the reference lacks — SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from haskell_path_tracer.core import linalg

finite = dict(allow_nan=False, allow_infinity=False, width=32)
angles_st = st.tuples(
    *[st.floats(-3.140625, 3.140625, **finite)] * 3
)


def quat_rotate_ref(q, v):
    """Reference rotation via explicit quaternion products (linear's
    `rotate`: imaginary part of q * (0, v) * conj q)."""
    w, x, y, z = q

    def qmul(a, b):
        aw, ax, ay, az = a
        bw, bx, by, bz = b
        return (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        )

    p = qmul(qmul((w, x, y, z), (0.0, *v)), (w, -x, -y, -z))
    return np.array(p[1:])


@settings(max_examples=50, deadline=None)
@given(angles_st, st.tuples(*[st.floats(-10.0, 10.0, **finite)] * 3))
def test_quat_rotate_matches_quaternion_products(angles, v):
    q = np.asarray(
        linalg.angles_to_quaternion(jnp.asarray(angles, jnp.float32))
    )
    got = np.asarray(
        linalg.quat_rotate(
            jnp.asarray(q, jnp.float32), jnp.asarray(v, jnp.float32)
        )
    )
    expected = quat_rotate_ref(q.astype(np.float64), np.asarray(v, np.float64))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


@settings(max_examples=50, deadline=None)
@given(angles_st)
def test_angles_to_quaternion_is_unit(angles):
    q = np.asarray(
        linalg.angles_to_quaternion(jnp.asarray(angles, jnp.float32))
    )
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, rtol=1e-5)


@settings(max_examples=50, deadline=None)
@given(angles_st, st.tuples(*[st.floats(-10.0, 10.0, **finite)] * 3))
def test_rotation_preserves_length(angles, v):
    q = linalg.angles_to_quaternion(jnp.asarray(angles, jnp.float32))
    out = linalg.quat_rotate(q, jnp.asarray(v, jnp.float32))
    np.testing.assert_allclose(
        float(linalg.norm(out)),
        np.linalg.norm(np.asarray(v, np.float32)),
        rtol=1e-4,
        atol=1e-4,
    )


def test_zero_rotation_is_identity():
    q = linalg.angles_to_quaternion(jnp.zeros(3))
    v = jnp.asarray([1.0, 2.0, 3.0])
    np.testing.assert_allclose(
        np.asarray(linalg.quat_rotate(q, v)), [1, 2, 3], atol=1e-6
    )
    # Unrotated camera looks down -Z (Util.hs:96-97)
    np.testing.assert_allclose(
        np.asarray(linalg.angles_to_direction(jnp.zeros(3))),
        [0, 0, -1],
        atol=1e-6,
    )


def test_euler_slot_semantics():
    """The reference's wiki-formula Euler slots, in camera terms
    (verified against the formula at Util.hs:55-67): slot 0 pitches about
    X, slot 1 yaws about Y, slot 2 rolls about the view axis."""
    d = linalg.angles_to_direction(jnp.asarray([np.pi / 2, 0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(d), [0, 1, 0], atol=1e-6)
    d = linalg.angles_to_direction(jnp.asarray([0.0, np.pi / 2, 0.0]))
    np.testing.assert_allclose(np.asarray(d), [-1, 0, 0], atol=1e-6)
    d = linalg.angles_to_direction(jnp.asarray([0.0, 0.0, np.pi / 2]))
    np.testing.assert_allclose(np.asarray(d), [0, 0, -1], atol=1e-6)


def test_reflect():
    d = jnp.asarray([1.0, -1.0, 0.0]) / np.sqrt(2)
    n = jnp.asarray([0.0, 1.0, 0.0])
    r = np.asarray(linalg.reflect(d, n))
    np.testing.assert_allclose(r, np.array([1.0, 1.0, 0.0]) / np.sqrt(2), atol=1e-6)


def test_near_zero():
    assert bool(linalg.near_zero(jnp.asarray([1e-4, 0.0, 0.0])))
    assert not bool(linalg.near_zero(jnp.asarray([2e-3, 0.0, 0.0])))
