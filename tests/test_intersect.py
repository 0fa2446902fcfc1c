"""Intersection contract tests.

Port of the reference's 8 hedgehog properties
(/root/reference/test/Scene/Intersection/Tests.hs:32-116) to hypothesis,
plus SoA nearest-hit resolution tests the reference lacks (SURVEY.md §4
"gaps to not inherit").
"""

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from haskell_path_tracer.models.objects import (
    BRDF_MATTE,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops.intersect import (
    INFINITE,
    nearest_hit,
    plane_distances,
    sphere_distances,
)

finite = dict(allow_nan=False, allow_infinity=False, width=32)


def f32s(lo, hi):
    """float32-representable bounds for hypothesis width=32 strategies."""
    return st.floats(float(np.float32(lo)), float(np.float32(hi)), **finite)


def dummy_materials(n):
    return make_materials([([1.0, 1.0, 1.0], 1.0, BRDF_MATTE, 1.0)] * n)


def sphere(pos, radius):
    return make_spheres([pos], [radius], dummy_materials(1))


def plane(pos, normal):
    return make_planes([pos], [normal], dummy_materials(1))


def dist_to_sphere(origin, direction, s):
    t = sphere_distances(
        jnp.asarray(origin, jnp.float32), jnp.asarray(direction, jnp.float32), s
    )
    return np.asarray(t)[0]


def dist_to_plane(origin, direction, p):
    t = plane_distances(
        jnp.asarray(origin, jnp.float32), jnp.asarray(direction, jnp.float32), p
    )
    return np.asarray(t)[0]


def normalized(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


# --- Sphere properties (Tests.hs:32-73) ------------------------------------


@settings(max_examples=60, deadline=None)
@given(f32s(0.1, 100.0))
def test_sphere_hit_point_on_axis(diameter):
    """intersection ((x, 0, x), x) = (0, 0, x)  (Tests.hs:35-42)."""
    s = sphere([diameter, 0.0, diameter], diameter)
    t = dist_to_sphere([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], s)
    assert t < INFINITE
    hit_pos = np.array([0.0, 0.0, 1.0]) * t
    np.testing.assert_allclose(
        hit_pos, [0.0, 0.0, diameter], rtol=1e-3, atol=1e-3
    )


@settings(max_examples=60, deadline=None)
@given(f32s(0.1, 100.0), f32s(0.1, 100.0))
def test_sphere_diagonal_distance(diameter, offset):
    """distanceTo ((x,x,x), y) = sqrt(3 y^2) - y + sqrt(3 (x-y)^2)
    (Tests.hs:43-58)."""
    pos = diameter + offset
    s = sphere([pos, pos, pos], diameter)
    t = dist_to_sphere([0.0, 0.0, 0.0], normalized([1.0, 1.0, 1.0]), s)
    expected = np.sqrt(3 * diameter**2) - diameter + np.sqrt(3 * offset**2)
    assert t < INFINITE
    np.testing.assert_allclose(t, expected, rtol=1e-3, atol=0.05)


@settings(max_examples=60, deadline=None)
@given(
    f32s(0.1, 100.0),
    st.tuples(*[f32s(-1.0, 1.0)] * 3).filter(
        lambda v: np.linalg.norm(v) > 1e-3
    ),
)
def test_sphere_backface_culling(diameter, direction):
    """Rays starting inside a sphere register no hit (Tests.hs:59-66)."""
    s = sphere([0.0, 0.0, 0.0], diameter)
    t = dist_to_sphere([0.0, 0.0, 0.0], normalized(direction), s)
    assert t == INFINITE


@settings(max_examples=60, deadline=None)
@given(
    st.tuples(*[f32s(-1.0, 1.0)] * 3).filter(
        lambda v: np.linalg.norm(v) > 1e-3
    )
)
def test_sphere_no_backwards_intersections(direction):
    """A sphere strictly behind the ray origin is not hit (Tests.hs:67-72)."""
    d = normalized(direction)
    s = sphere(list(-d), 0.1)
    t = dist_to_sphere([0.0, 0.0, 0.0], d, s)
    assert t == INFINITE


# --- Plane properties (Tests.hs:75-116) ------------------------------------


@settings(max_examples=60, deadline=None)
@given(
    st.tuples(*[f32s(-1000.0, 1000.0)] * 3).filter(
        # XLA:CPU flushes denormals to zero; skip the sub-normal sliver where
        # the z >= 0 branch choice depends on denormal support.
        lambda v: v[2] == 0.0 or abs(v[2]) > 1e-6
    )
)
def test_plane_straight_on(pos):
    """Head-on hit at distance z, miss when the plane is behind
    (Tests.hs:78-85)."""
    p = plane(list(pos), [0.0, 0.0, -1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], p)
    z = np.float32(pos[2])
    if z >= 0.0:
        np.testing.assert_allclose(t, z, rtol=1e-5, atol=1e-5)
    else:
        assert t == INFINITE


@settings(max_examples=60, deadline=None)
@given(st.tuples(*[f32s(-1000.0, 1000.0)] * 3))
def test_plane_backface_straight_on(pos):
    """One-sided: a plane facing away is never hit (Tests.hs:86-93)."""
    p = plane(list(pos), [0.0, 0.0, 1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], [0.0, 0.0, 1.0], p)
    assert t == INFINITE


@settings(max_examples=60, deadline=None)
@given(
    f32s(-1000.0, 1000.0), f32s(-1000.0, 1000.0)
)
def test_plane_angled(x, y):
    """Angled hit at distance 1/cos(angle) (Tests.hs:94-107)."""
    d = normalized([x, y, 1.0])
    p = plane([0.0, 0.0, 1.0], [0.0, 0.0, -1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], d, p)
    cos_angle = d[2]
    expected = 1.0 / cos_angle
    if expected >= 0.0:
        np.testing.assert_allclose(t, expected, rtol=1e-4, atol=1e-4)
    else:
        assert t == INFINITE


@settings(max_examples=60, deadline=None)
@given(
    f32s(-1000.0, 1000.0), f32s(-1000.0, 1000.0)
)
def test_plane_angled_backface(x, y):
    """Angled backface culling (Tests.hs:108-115)."""
    d = normalized([x, y, 1.0])
    p = plane([0.0, 0.0, 1.0], [0.0, 0.0, 1.0])
    t = dist_to_plane([0.0, 0.0, 0.0], d, p)
    assert t == INFINITE


# --- nearest-hit resolution (new coverage) ---------------------------------


def test_nearest_hit_picks_closest_and_breaks_ties_first():
    # Two spheres straight ahead at z=5 (r=1) and z=10 (r=1): hit the near one.
    s = make_spheres(
        [[0, 0, 5], [0, 0, 10]], [1.0, 1.0], dummy_materials(2)
    )
    p = make_planes([[0, 0, 20]], [[0, 0, -1]], dummy_materials(1))
    scene = Scene(spheres=s, planes=p)
    o = jnp.zeros((3,), jnp.float32)
    d = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    h = nearest_hit(o, d, scene)
    assert bool(h.hit)
    assert int(h.prim) == 0
    np.testing.assert_allclose(float(h.t), 4.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.normal), [0, 0, -1], atol=1e-5)


def test_nearest_hit_batched_miss_and_plane():
    s = make_spheres([[0, 0, 5]], [1.0], dummy_materials(1))
    p = make_planes([[0, -3, 0]], [[0, 1, 0]], dummy_materials(1))
    scene = Scene(spheres=s, planes=p)
    o = jnp.zeros((2, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0]], jnp.float32)
    h = nearest_hit(o, d, scene)
    assert not bool(h.hit[0])  # looking backwards: miss everything
    assert bool(h.hit[1])  # looking down: hit the floor plane
    assert int(h.prim[1]) == 1  # index 1 = first plane (after 1 sphere)
    np.testing.assert_allclose(float(h.t[1]), 3.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.point[1]), [0, -3, 0], atol=1e-5)
