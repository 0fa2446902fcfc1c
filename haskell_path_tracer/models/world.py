"""The reference's hard-coded demo scene and initial camera, as data.

Behavioral parity fixture for upstream src/Scene/World.hs:8-77 —
five spheres (two matte, one perfect-mirror glossy, two emissive) and two
one-sided planes (floor + ceiling).  The reference bakes this scene into the
compiled kernel as constants (World.hs:16); here it is just a `Scene` pytree
value, so it is both a test fixture and an ordinary runtime input.
"""

from __future__ import annotations

from .objects import (
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)


def initial_camera() -> Camera:
    """World.hs:8-12."""
    return Camera.create(
        position=[1.0, -1.6, -4.8],
        rotation=[0.314, -0.314, 0.0],
        fov=90.0,
    )


def main_scene() -> Scene:
    """World.hs:15-77, in declaration order (order matters: nearest-hit
    tie-breaking keeps the earliest primitive, spheres before planes —
    upstream src/Util.hs:171-178)."""
    sphere_mats = make_materials(
        [
            ([1.0, 0.3, 0.3], 0.0, BRDF_MATTE, 0.8),
            ([0.0, 0.4, 0.0], 0.0, BRDF_MATTE, 0.9),
            ([0.4, 0.4, 1.0], 0.0, BRDF_GLOSSY, 1.0),
            ([0.8, 0.8, 0.8], 6942.0, BRDF_GLOSSY, 0.5),
            ([0.99, 0.84, 0.12], 4420.0, BRDF_MATTE, 1.0),
        ]
    )
    spheres = make_spheres(
        pos=[
            [2.0, 2.0, -14.0],
            [6.0, 2.0, -9.0],
            [4.5, 1.0, -9.0],
            [16.0, -2.05, -20.0],
            [5.0, 10.0, 4.0],
        ],
        radius=[5.0, 1.5, 0.5, 0.9, 2.0],
        materials=sphere_mats,
    )
    plane_mats = make_materials(
        [
            ([0.43, 0.95, 0.5], 0.0, BRDF_MATTE, 1.5),
            ([0.26, 0.68, 0.88], 0.0, BRDF_GLOSSY, 0.9),
        ]
    )
    planes = make_planes(
        pos=[[0.0, -3.0, 0.0], [0.0, 15.0, 0.0]],
        normal=[[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
        materials=plane_mats,
    )
    return Scene(spheres=spheres, planes=planes)
