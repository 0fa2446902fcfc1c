"""Axis-aligned box and triangle primitives — the reference's declared
TODOs (Objects.hs:47-59) implemented array-natively.

Property style follows the reference's intersection contract
(test/Scene/Intersection/Tests.hs): analytic distances, one-sided
(backface-cull) semantics, no backwards intersections — extended to the
two new kinds, plus nearest-hit merge ordering and integrator smoke
coverage.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from haskell_path_tracer.models.objects import (
    BRDF_MATTE,
    Scene,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)
from haskell_path_tracer.ops.intersect import (
    INFINITE,
    box_distances,
    box_normal,
    nearest_hit,
    triangle_distances,
)

MAT = make_materials([([0.8, 0.2, 0.2], 0.0, BRDF_MATTE, 1.0)])


def unit_box():
    return make_boxes([[-1.0, -1.0, -1.0]], [[1.0, 1.0, 1.0]], MAT)


def xy_triangle():
    # Right triangle in the z=0 plane; geometric normal cross(e1,e2) = +z.
    return make_triangles(
        [[0.0, 0.0, 0.0]], [[2.0, 0.0, 0.0]], [[0.0, 2.0, 0.0]], MAT
    )


def _t(fn, o, d, prims):
    return float(
        np.asarray(
            fn(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32), prims)
        )[0]
    )


# --- boxes -------------------------------------------------------------------


def test_box_axis_hit_distance():
    assert _t(box_distances, [0, 0, 5], [0, 0, -1], unit_box()) == 4.0
    assert _t(box_distances, [5, 0, 0], [-1, 0, 0], unit_box()) == 4.0
    assert _t(box_distances, [0, -9, 0], [0, 1, 0], unit_box()) == 8.0


def test_box_diagonal_hit_distance():
    # From (2,2,2) toward origin: entry at the (1,1,1) corner, t = sqrt(3).
    d = np.array([-1.0, -1.0, -1.0]) / np.sqrt(3)
    t = _t(box_distances, [2, 2, 2], d.tolist(), unit_box())
    np.testing.assert_allclose(t, np.sqrt(3), rtol=1e-5)


def test_box_miss():
    assert _t(box_distances, [0, 5, 5], [0, 0, -1], unit_box()) == INFINITE
    assert _t(box_distances, [0, 0, 5], [0, 0, 1], unit_box()) == INFINITE


def test_box_inside_origin_is_culled():
    """One-sided semantics: a ray born inside the box misses it (the
    sphere backface-cull rule, Intersection.hs:46-48, extended)."""
    assert _t(box_distances, [0, 0, 0], [0, 0, -1], unit_box()) == INFINITE


def test_box_no_backwards_hit():
    assert _t(box_distances, [0, 0, -5], [0, 0, -1], unit_box()) == INFINITE


def test_box_normal_faces():
    lo = jnp.asarray([[-1.0, -1.0, -1.0]])
    hi = jnp.asarray([[1.0, 1.0, 1.0]])
    for point, expect in [
        ([0.3, -0.2, 1.0], [0, 0, 1]),
        ([0.3, -0.2, -1.0], [0, 0, -1]),
        ([1.0, 0.5, 0.5], [1, 0, 0]),
        ([-1.0, 0.5, 0.5], [-1, 0, 0]),
        ([0.1, 1.0, -0.9], [0, 1, 0]),
    ]:
        n = np.asarray(box_normal(jnp.asarray([point], jnp.float32), lo, hi))
        np.testing.assert_allclose(n[0], expect, atol=1e-6)


def test_box_axis_parallel_grazing_ray():
    # Direction has an exact zero component; slab math must stay NaN-free.
    t = _t(box_distances, [0.5, 0.0, 5.0], [0, 0, -1], unit_box())
    assert t == 4.0
    t = _t(box_distances, [5.0, 0.0, 5.0], [0, 0, -1], unit_box())
    assert t == INFINITE


# --- triangles ---------------------------------------------------------------


def test_triangle_straight_on_distance():
    assert _t(triangle_distances, [0.5, 0.5, 3], [0, 0, -1], xy_triangle()) == 3.0


def test_triangle_backface_cull():
    """Front face is the +z side (plane convention, Intersection.hs:57):
    approaching from -z (travelling with the normal) misses."""
    assert (
        _t(triangle_distances, [0.5, 0.5, -3], [0, 0, 1], xy_triangle())
        == INFINITE
    )


def test_triangle_outside_edges_miss():
    tri = xy_triangle()
    assert _t(triangle_distances, [1.5, 1.5, 3], [0, 0, -1], tri) == INFINITE
    assert _t(triangle_distances, [-0.1, 0.5, 3], [0, 0, -1], tri) == INFINITE
    assert _t(triangle_distances, [0.5, -0.1, 3], [0, 0, -1], tri) == INFINITE


def test_triangle_no_backwards_hit():
    assert (
        _t(triangle_distances, [0.5, 0.5, -3], [0, 0, -1], xy_triangle())
        == INFINITE
    )


def test_triangle_angled_distance():
    # 45-degree approach in the y-z plane: path length = 3 * sqrt(2).
    d = np.array([0.0, -1.0, -1.0]) / np.sqrt(2)
    t = _t(triangle_distances, [0.5, 3.5, 3.0], d.tolist(), xy_triangle())
    np.testing.assert_allclose(t, 3 * np.sqrt(2), rtol=1e-5)


def test_triangle_parallel_ray_misses():
    assert (
        _t(triangle_distances, [0.5, 0.5, 1.0], [1, 0, 0], xy_triangle())
        == INFINITE
    )


# --- nearest-hit integration -------------------------------------------------


def full_scene():
    spheres = make_spheres([[0.0, 0.0, -10.0]], [1.0], MAT)
    planes = make_planes(
        [[0.0, -5.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.2, 0.8, 0.2], 0.0, BRDF_MATTE, 1.0)]),
    )
    boxes = make_boxes(
        [[-1.0, -1.0, -7.0]],
        [[1.0, 1.0, -5.0]],
        make_materials([([0.2, 0.2, 0.8], 0.0, BRDF_MATTE, 1.0)]),
    )
    tris = make_triangles(
        [[-2.0, -2.0, -3.0]],
        [[2.0, -2.0, -3.0]],
        [[0.0, 2.0, -3.0]],
        make_materials([([0.9, 0.9, 0.1], 2.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=spheres, planes=planes, boxes=boxes, triangles=tris)


def test_nearest_hit_orders_all_kinds():
    scene = full_scene()
    o = jnp.asarray([[0.0, 0.0, 5.0]] * 1, jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = nearest_hit(o, d, scene)
    # Triangle (z=-3) is nearest, then box (z=-5), then sphere (z=-9).
    assert bool(h.hit[0])
    assert int(h.prim[0]) == 3  # spheres(1) ++ planes(1) ++ boxes(1) -> tri idx 3
    np.testing.assert_allclose(float(h.t[0]), 8.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.color[0]), [0.9, 0.9, 0.1], atol=1e-6)
    np.testing.assert_allclose(float(h.illuminance[0]), 2.0, atol=1e-6)


def test_nearest_hit_box_when_triangle_removed():
    scene = full_scene()
    scene = dataclasses.replace(
        scene,
        triangles=dataclasses.replace(
            scene.triangles,
            v0=scene.triangles.v0[:0],
            v1=scene.triangles.v1[:0],
            v2=scene.triangles.v2[:0],
            material=dataclasses.replace(
                scene.triangles.material,
                color=scene.triangles.material.color[:0],
                illuminance=scene.triangles.material.illuminance[:0],
                brdf_kind=scene.triangles.material.brdf_kind[:0],
                brdf_param=scene.triangles.material.brdf_param[:0],
            ),
        ),
    )
    o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = nearest_hit(o, d, scene)
    np.testing.assert_allclose(float(h.t[0]), 10.0, rtol=1e-6)  # box face z=-5
    assert int(h.prim[0]) == 2
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.color[0]), [0.2, 0.2, 0.8], atol=1e-6)


def test_chunked_path_matches_small_path_with_extended_kinds():
    """Force the chunked scan (>128 prims) and cross-check against the
    direct formulation on a mixed-kind scene."""
    from haskell_path_tracer.ops import intersect as I

    rng = np.random.default_rng(5)
    n = 150
    spheres = make_spheres(
        rng.uniform(-8, 8, (n, 3)),
        rng.uniform(0.2, 0.8, (n,)),
        make_materials([([0.5, 0.5, 0.5], 0.0, BRDF_MATTE, 1.0)] * n),
    )
    scene = dataclasses.replace(full_scene(), spheres=spheres)
    o = jnp.asarray(rng.uniform(-10, 10, (256, 3)), jnp.float32)
    d = jnp.asarray(
        rng.normal(size=(256, 3)) / np.linalg.norm(
            rng.normal(size=(256, 3)), axis=-1, keepdims=True
        ),
        jnp.float32,
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    t_c, p_c = I._nearest_t_prim_chunked(o, d, scene)
    t_s, p_s = I._nearest_t_prim_small(o, d, scene)
    t_c, p_c = np.asarray(t_c), np.asarray(p_c)
    t_s, p_s = np.asarray(t_s), np.asarray(p_s)
    # The two formulations fuse differently, so distances can differ by
    # ulps (measured ~2e-6 relative); winners may flip only on lanes where
    # two primitives are that close.
    np.testing.assert_allclose(t_c, t_s, rtol=1e-4)
    exact = t_c == t_s
    assert exact.mean() > 0.9
    np.testing.assert_array_equal(p_c[exact], p_s[exact])


def test_integrators_render_extended_scene():
    """Inline and wavefront agree bit-for-bit on a scene containing all
    four primitive kinds (the wavefront≡inline contract extends)."""
    from haskell_path_tracer.models.objects import Camera
    from haskell_path_tracer.render.integrator import (
        make_accumulator,
        render_batch_inline,
    )
    from haskell_path_tracer.render.wavefront import (
        render_sample_wavefront,
    )

    scene = full_scene()
    camera = Camera.create([0.0, 0.0, 6.0], [0.0, 0.0, 0.0], 90.0)
    acc = make_accumulator(32, 24, seed=9)
    a = render_batch_inline(scene, camera, acc, spp=2, num_bounces=4)
    b = render_sample_wavefront(scene, camera, acc, num_bounces=4)
    b = render_sample_wavefront(scene, camera, b, num_bounces=4)
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))
    np.testing.assert_allclose(
        np.asarray(a.color), np.asarray(b.color), atol=1e-5
    )
    # The emissive triangle contributes: image is not black.
    assert np.asarray(a.color).sum() > 0


def test_scene_json_roundtrip_with_boxes_triangles(tmp_path):
    from haskell_path_tracer.models.io import load_scene, save_scene

    scene = full_scene()
    path = str(tmp_path / "scene.json")
    save_scene(path, scene)
    loaded, _ = load_scene(path)
    assert loaded.boxes.count == 1 and loaded.triangles.count == 1
    np.testing.assert_allclose(
        np.asarray(loaded.boxes.lo), np.asarray(scene.boxes.lo)
    )
    np.testing.assert_allclose(
        np.asarray(loaded.triangles.v2), np.asarray(scene.triangles.v2)
    )
    o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    np.testing.assert_allclose(
        float(nearest_hit(o, d, loaded).t[0]),
        float(nearest_hit(o, d, scene).t[0]),
    )


def test_tiny_triangle_is_hittable():
    """The front-face epsilon must scale with triangle area (an absolute
    1e-6 on the unnormalized Moller-Trumbore determinant silently culled
    every sub-millimeter triangle)."""
    tri = make_triangles(
        [[0.0, 0.0, 0.0]], [[5e-4, 0.0, 0.0]], [[0.0, 5e-4, 0.0]], MAT
    )
    t = _t(triangle_distances, [1e-4, 1e-4, 1.0], [0, 0, -1], tri)
    np.testing.assert_allclose(t, 1.0, rtol=1e-6)
    # Backface cull still holds for the tiny triangle.
    assert (
        _t(triangle_distances, [1e-4, 1e-4, -1.0], [0, 0, 1], tri)
        == INFINITE
    )
    # Near-parallel grazing rays are culled like one-sided planes.
    big = make_triangles(
        [[-100.0, -100.0, 0.0]], [[100.0, -100.0, 0.0]], [[0.0, 100.0, 0.0]],
        MAT,
    )
    t = _t(
        triangle_distances,
        [0.0, 0.0, 1.0],
        (np.array([1.0, 0.0, -1e-7]) / np.sqrt(1 + 1e-14)).tolist(),
        big,
    )
    assert t == INFINITE
