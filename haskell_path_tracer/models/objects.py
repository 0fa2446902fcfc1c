"""Scene data model as structure-of-arrays pytrees.

Array-native redesign of the reference's GPU datatypes
(upstream src/Scene/Objects.hs:28-131).  Where the Haskell reference
stores an *array of structs* (`Matrix (Color, SFC32)`, record types with
lenses) and works around Accelerate's missing sum types by unrolling over a
Haskell list of primitives (upstream src/Util.hs:138-158), we store
each field as its own contiguous array:

  * a `Spheres` batch is `pos[N,3], radius[N]` + a `Materials` batch — all
    primitives of one kind are intersected with one vectorized op, no
    compile-time unrolling, scaling to thousands of primitives;
  * the BRDF sum type `Matte p | Glossy p` (Objects.hs:77-87) becomes a
    dense integer tag array + parameter array, dispatched with `jnp.where`
    (branchless — both BRDF branches cost a handful of vector flops, far cheaper
    than divergence machinery);
  * the per-pixel accumulator `RenderResult = Matrix (Color, SFC32)`
    (Objects.hs:36) becomes the `Accumulator` pytree of
    `color[H,W,3] f32` + `rng[H,W,4] u32` + scalar iteration count.

All classes are registered with `jax.tree_util.register_dataclass`, so they
flow through `jit` / `grad` / `shard_map` as pytrees with static structure.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# BRDF kind tags (the reference's `Brdf` sum type, Objects.hs:77-87).
# DIELECTRIC extends the reference: it is the refraction material the
# reference only stubbed (ray splitting, upstream src/Scene/Trace.hs:116-118).
BRDF_MATTE = 0
BRDF_GLOSSY = 1
BRDF_DIELECTRIC = 2


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass(frozen=True)
class Materials:
    """SoA material batch (Objects.hs:90-100 `Material`).

    color        [N, 3] f32 — albedo
    illuminance  [N]    f32 — emission scale (emittance = color * illuminance)
    brdf_kind    [N]    i32 — BRDF_MATTE / BRDF_GLOSSY / BRDF_DIELECTRIC
    brdf_param   [N]    f32 — the Matte/Glossy parameter p; for dielectric,
                              the index of refraction
    """

    color: jnp.ndarray
    illuminance: jnp.ndarray
    brdf_kind: jnp.ndarray
    brdf_param: jnp.ndarray

    @property
    def count(self) -> int:
        return self.color.shape[0]


@_register
@dataclass(frozen=True)
class Spheres:
    """SoA sphere batch (Objects.hs:126-131 `Sphere`)."""

    pos: jnp.ndarray  # [N, 3]
    radius: jnp.ndarray  # [N]
    material: Materials

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@_register
@dataclass(frozen=True)
class Planes:
    """SoA one-sided infinite plane batch (Objects.hs:103-108 `Plane`).

    `normal` is the reference's `_planeDirection`; planes only intersect
    rays travelling *against* the normal (Intersection.hs:57).
    """

    pos: jnp.ndarray  # [M, 3]
    normal: jnp.ndarray  # [M, 3]
    material: Materials

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@_register
@dataclass(frozen=True)
class Boxes:
    """SoA axis-aligned box batch.

    Implements the reference's *stubbed* `AxisAlignedBox` (Objects.hs:47-51
    declares the type and the TODO at :55-59 never fills it in).  One-sided
    like every other primitive here: only entry faces hit — a ray starting
    inside a box misses it (the sphere's backface-cull rule, extended).
    """

    lo: jnp.ndarray  # [N, 3] min corner
    hi: jnp.ndarray  # [N, 3] max corner
    material: Materials

    @property
    def count(self) -> int:
        return self.lo.shape[0]


@_register
@dataclass(frozen=True)
class Triangles:
    """SoA triangle batch (the reference's other TODO, Objects.hs:55-59).

    One-sided with the plane's convention (Intersection.hs:57): the front
    face is the side the geometric normal `normalize(cross(v1-v0, v2-v0))`
    points toward, and only front faces hit.
    """

    v0: jnp.ndarray  # [N, 3]
    v1: jnp.ndarray  # [N, 3]
    v2: jnp.ndarray  # [N, 3]
    material: Materials

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def empty_materials() -> Materials:
    return Materials(
        color=jnp.zeros((0, 3), jnp.float32),
        illuminance=jnp.zeros((0,), jnp.float32),
        brdf_kind=jnp.zeros((0,), jnp.int32),
        brdf_param=jnp.zeros((0,), jnp.float32),
    )


def empty_boxes() -> Boxes:
    return Boxes(
        lo=jnp.zeros((0, 3), jnp.float32),
        hi=jnp.zeros((0, 3), jnp.float32),
        material=empty_materials(),
    )


def empty_triangles() -> Triangles:
    return Triangles(
        v0=jnp.zeros((0, 3), jnp.float32),
        v1=jnp.zeros((0, 3), jnp.float32),
        v2=jnp.zeros((0, 3), jnp.float32),
        material=empty_materials(),
    )


@_register
@dataclass(frozen=True)
class Scene:
    """A scene = sphere batch + plane batch (Objects.hs:60-64 `Scene`),
    extended with the primitive kinds the reference only declared as TODOs
    (axis-aligned boxes, triangles — Objects.hs:47-59).  Primitive index
    order is spheres ++ planes ++ boxes ++ triangles.

    Unlike the reference — where the scene is baked into the compiled kernel
    as constants (World.hs:16) — a `Scene` is a pytree of *traced* arrays:
    the same jitted renderer serves any scene of the same primitive counts,
    and gradients w.r.t. every field are available for inverse rendering.
    """

    spheres: Spheres
    planes: Planes
    boxes: Boxes = dataclasses.field(default_factory=empty_boxes)
    triangles: Triangles = dataclasses.field(default_factory=empty_triangles)

    @property
    def num_primitives(self) -> int:
        return (
            self.spheres.count
            + self.planes.count
            + self.boxes.count
            + self.triangles.count
        )


@_register
@dataclass(frozen=True)
class Camera:
    """Pinhole camera (Objects.hs:67-74): position, Euler rotation
    (roll, pitch, yaw), vertical FOV in degrees.

    Stored as arrays so the camera stays a *traced* jit argument — moving the
    camera never recompiles, mirroring the reference's `compileFor` design
    (upstream app/Main.hs:185-191).
    """

    position: jnp.ndarray  # [3] f32
    rotation: jnp.ndarray  # [3] f32 (roll, pitch, yaw)
    fov: jnp.ndarray  # [] f32, degrees

    @staticmethod
    def create(position, rotation, fov) -> "Camera":
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            rotation=jnp.asarray(rotation, jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
        )


@_register
@dataclass(frozen=True)
class Rays:
    """SoA ray batch (Objects.hs:114-119 `Ray`)."""

    origin: jnp.ndarray  # [..., 3]
    direction: jnp.ndarray  # [..., 3]


@_register
@dataclass(frozen=True)
class Accumulator:
    """Progressive render state — the reference's `RenderResult`
    (Objects.hs:28-36) plus the iteration counter the reference keeps host-side
    (upstream app/Main.hs:92-98).

    color      [H, W, 3] f32 — accumulated (unnormalized) radiance sum
    rng        [H, W, 4] u32 — per-pixel SFC32 state (a, b, c, counter)
    iterations []        i32 — samples accumulated so far
    """

    color: jnp.ndarray
    rng: jnp.ndarray
    iterations: jnp.ndarray

    @property
    def image(self) -> jnp.ndarray:
        """Normalized image: accumulated color / iterations.

        The reference performs this division in its display fragment shader
        (upstream app/assets/fs.glsl:12); here it is a jnp one-liner.
        """
        return self.color / jnp.maximum(self.iterations, 1).astype(jnp.float32)


def make_materials(entries) -> Materials:
    """Build a `Materials` SoA batch from a list of
    (color, illuminance, brdf_kind, brdf_param) tuples."""
    color = np.array([e[0] for e in entries], np.float32).reshape(-1, 3)
    illum = np.array([e[1] for e in entries], np.float32)
    kind = np.array([e[2] for e in entries], np.int32)
    param = np.array([e[3] for e in entries], np.float32)
    return Materials(
        color=jnp.asarray(color),
        illuminance=jnp.asarray(illum),
        brdf_kind=jnp.asarray(kind),
        brdf_param=jnp.asarray(param),
    )


def make_spheres(pos, radius, materials: Materials) -> Spheres:
    return Spheres(
        pos=jnp.asarray(np.array(pos, np.float32).reshape(-1, 3)),
        radius=jnp.asarray(np.array(radius, np.float32)),
        material=materials,
    )


def make_planes(pos, normal, materials: Materials) -> Planes:
    return Planes(
        pos=jnp.asarray(np.array(pos, np.float32).reshape(-1, 3)),
        normal=jnp.asarray(np.array(normal, np.float32).reshape(-1, 3)),
        material=materials,
    )


def make_boxes(lo, hi, materials: Materials) -> Boxes:
    return Boxes(
        lo=jnp.asarray(np.array(lo, np.float32).reshape(-1, 3)),
        hi=jnp.asarray(np.array(hi, np.float32).reshape(-1, 3)),
        material=materials,
    )


def make_triangles(v0, v1, v2, materials: Materials) -> Triangles:
    return Triangles(
        v0=jnp.asarray(np.array(v0, np.float32).reshape(-1, 3)),
        v1=jnp.asarray(np.array(v1, np.float32).reshape(-1, 3)),
        v2=jnp.asarray(np.array(v2, np.float32).reshape(-1, 3)),
        material=materials,
    )
