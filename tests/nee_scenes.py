"""Scenes shared by the physical/NEE estimator tests."""

import numpy as np

from haskell_path_tracer.models.objects import (
    BRDF_DIELECTRIC,
    BRDF_GLOSSY,
    BRDF_MATTE,
    Scene,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)


def cornell8():
    rng = np.random.default_rng(0)
    pos = rng.uniform([-3, -2, -8], [3, 2, -4], (8, 3))
    mats = make_materials(
        [
            (rng.uniform(0.2, 0.9, 3).tolist(),
             30.0 if i == 0 else 0.0,
             BRDF_GLOSSY if i % 3 == 2 else BRDF_MATTE,
             0.9)
            for i in range(8)
        ]
    )
    s = make_spheres(pos.tolist(), rng.uniform(0.4, 1.0, 8).tolist(), mats)
    p = make_planes(
        [[0, -3, 0], [0, 8, 0]],
        [[0, 1, 0], [0, -1, 0]],
        make_materials(
            [([0.7, 0.7, 0.7], 0.0, BRDF_MATTE, 1.2),
             ([0.8, 0.8, 0.8], 0.0, BRDF_MATTE, 1.0)]
        ),
    )
    return Scene(spheres=s, planes=p)


def big(n=120):
    rng = np.random.default_rng(7)
    pos = rng.uniform([-30, -2.5, -60], [30, 10, -8], (n, 3))
    radius = rng.uniform(0.2, 0.9, n)
    illum = np.where(rng.random(n) < 0.05, 50.0, 0.0)
    mats = make_materials(
        [
            (rng.uniform(0.2, 0.9, 3).tolist(), float(illum[i]),
             BRDF_MATTE, 1.0)
            for i in range(n)
        ]
    )
    s = make_spheres(pos.tolist(), radius.tolist(), mats)
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.6], 0.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=s, planes=p)


def glassy():
    s = make_spheres(
        [[0.0, 0.0, -4.0], [1.8, 0.5, -6.0], [-2.0, 1.0, -5.0]],
        [1.3, 0.9, 0.7],
        make_materials(
            [([0.97, 0.98, 1.0], 0.0, BRDF_DIELECTRIC, 1.5),
             ([0.9, 0.95, 1.0], 0.0, BRDF_DIELECTRIC, 1.33),
             ([1.0, 0.9, 0.7], 8.0, BRDF_MATTE, 1.0)]
        ),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.5, 0.5, 0.6], 0.0, BRDF_MATTE, 1.2)]),
    )
    return Scene(spheres=s, planes=p)


def zero_light():
    """No emissive sphere: lit only by an emissive plane.  The estimator
    still draws the 3 light-sampling uniforms every bounce."""
    s = make_spheres(
        [[0.0, 0.0, -5.0], [1.5, 0.8, -4.0]],
        [1.2, 0.6],
        make_materials(
            [([0.8, 0.4, 0.3], 0.0, BRDF_MATTE, 1.0),
             ([0.4, 0.8, 0.5], 0.0, BRDF_GLOSSY, 1.0)]
        ),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0], [0.0, 9.0, 0.0]],
        [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
        make_materials(
            [([0.7, 0.7, 0.7], 0.0, BRDF_MATTE, 1.0),
             ([1.0, 1.0, 0.9], 4.0, BRDF_MATTE, 1.0)]
        ),
    )
    return Scene(spheres=s, planes=p)


def tri_scene():
    """Spheres + plane + triangles with BOTH a sphere emitter and a
    triangle area light (the estimator's flagship feature) plus a matte
    blocker triangle that casts shadows."""
    s = make_spheres(
        [[0.0, -1.0, -6.0], [-2.5, 0.0, -7.0], [2.3, -0.5, -5.5]],
        [1.6, 1.2, 1.0],
        make_materials([
            ([0.8, 0.4, 0.3], 0.0, BRDF_MATTE, 1.0),
            ([0.9, 0.9, 0.9], 0.0, BRDF_GLOSSY, 1.0),
            ([0.3, 0.8, 0.5], 6.0, BRDF_MATTE, 1.0),
        ]),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.55], 0.0, BRDF_MATTE, 1.0)]),
    )
    tr = make_triangles(
        [[-2.0, 5.0, -7.5], [-1.0, 0.5, -4.0]],
        [[2.0, 5.0, -7.5], [1.0, 0.5, -4.0]],
        [[0.0, 5.0, -4.5], [0.0, 2.0, -5.0]],
        make_materials([
            ([1.0, 0.95, 0.8], 20.0, BRDF_MATTE, 1.0),
            ([0.4, 0.5, 0.9], 0.0, BRDF_MATTE, 1.0),
        ]),
    )
    return Scene(spheres=s, planes=p, triangles=tr)


def box_tri_scene():
    """All four primitive kinds with three emitter classes: an NEE
    sphere light, an NEE triangle area light, and an EMISSIVE BOX
    (BSDF-only pickup — the estimator's `is_bsdf_only` rule)."""
    s = make_spheres(
        [[0.0, -1.0, -6.0], [2.5, 0.8, -7.0]], [1.6, 0.9],
        make_materials([
            ([0.8, 0.4, 0.3], 0.0, BRDF_MATTE, 1.0),
            ([0.9, 0.8, 0.2], 12.0, BRDF_MATTE, 1.0),
        ]),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]],
        make_materials([([0.6, 0.6, 0.55], 0.0, BRDF_MATTE, 1.0)]),
    )
    b = make_boxes(
        [[-3.0, -2.0, -7.5], [0.5, 2.0, -5.5]],
        [[-1.5, 0.5, -6.0], [1.5, 3.0, -4.8]],
        make_materials([
            ([0.5, 0.7, 0.9], 0.0, BRDF_GLOSSY, 1.0),
            ([1.0, 0.9, 0.7], 8.0, BRDF_MATTE, 1.0),
        ]),
    )
    tr = make_triangles(
        [[-1.0, 4.0, -7.0]], [[1.0, 4.0, -7.0]], [[0.0, 4.0, -5.0]],
        make_materials([([1.0, 1.0, 0.9], 15.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(spheres=s, planes=p, boxes=b, triangles=tr)
