"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

This capability has no counterpart in the reference (a forward-only
renderer); it is the framework's inverse-rendering subsystem (BASELINE.md
north star: "pixel gradients w.r.t. material/emission/geometry parameters
... validated against finite differences").

Design (Dr.Jit-style, see PAPERS.md):

  * the whole forward bounce loop is differentiated as a rematerialized
    `lax.scan` (`trace_inline(differentiable=True)`) — per-bounce hit data
    is recomputed in the backward sweep rather than stored;
  * *decisions are detached*: hit masks, nearest-primitive argmin, BRDF
    branch selection and RNG draws carry no tangents (they are integer/
    boolean ops), so we differentiate shading along fixed paths — visibility
    discontinuities are not differentiated (their measure-zero contribution
    is ignored, the standard path-space approximation);
  * gradients flow through intersection distances, normals, BRDF weights,
    throughput products and emission, covering every continuous scene leaf:
    material color / illuminance / BRDF parameter of all four primitive
    kinds, sphere position/radius, plane position and normal (renormalized
    after each update), box corners, and triangle vertices.  Only the
    integer BRDF kind tags are non-differentiable.

RNG states are held fixed for a given gradient evaluation, making the loss
deterministic — the same-seed trick that keeps finite-difference validation
meaningful.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.camera import primary_rays
from ..models.objects import Camera, Materials, Planes, Scene, Spheres
from ..ops import routes
from ..render.integrator import trace_inline


def render_radiance(
    scene: Scene,
    camera: Camera,
    rng_state: jnp.ndarray,
    width: int,
    height: int,
    num_bounces: int = 4,
    spp: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    row_offset=0,
    full_height: int | None = None,
    interpret: bool = False,
    estimator: str = "parity",
    kinds=None,
) -> jnp.ndarray:
    """Differentiable expected-radiance image [H, W, 3].

    `estimator="parity"` (default) differentiates the reference-parity
    inline integrator; `"physical"` differentiates the corrected-BRDF +
    NEE estimator (render/nee.py) — the production light transport,
    whose area-sampling term (A cos / d^2) carries the physically
    meaningful geometry gradients (e.g. emitter vertices; FD-validated
    in tests/test_grad.py).

    Averages `spp` samples, each advancing the RNG state; the state itself
    is treated as a constant (no tangent), so the function is a
    deterministic, differentiable map from scene parameters to pixels.

    `backend` ("xla", "pallas" or "auto") picks the route through
    ops/routes.py.  The parity estimator has a fused fwd+bwd Pallas
    megakernel (ops/pallas_megakernel_vjp.py): identical detach
    semantics, bit-equal forward, and each pixel's whole fwd+bwd bounce
    loop in one kernel.  It folds all four primitive kinds (cotangents
    verified against XLA in tests/test_pallas_vjp.py).  The physical
    estimator always runs on XLA.  `has_dielectric=False` (a static
    host-side fact, see `scene_has_dielectric`) elides the glass block
    bit-exactly on the kernel path.

    `row_offset`/`full_height` render a row block of a taller image (the
    sharded path: each device differentiates its own tile — see
    parallel/shard.py); `interpret` runs the Pallas kernel in interpret
    mode (tests only).
    """
    rays = primary_rays(camera, width, height, row_offset, full_height)

    if estimator == "physical":
        routes.use_kernel(backend, "physical")
        from ..render.nee import trace_physical

        def sample_p(carry, _):
            rng = carry
            radiance, rng = trace_physical(
                scene, rays, rng, num_bounces, nee=True, kinds=kinds
            )
            return rng, radiance

        _, radiances = jax.lax.scan(sample_p, rng_state, None, length=spp)
        return jnp.mean(radiances, axis=0)
    if estimator != "parity":
        raise ValueError(f"unknown estimator {estimator!r}")

    if routes.use_kernel(backend, "parity_grad", interpret=interpret):
        from ..ops.pallas_megakernel_vjp import trace_inline_pallas_diff

        rad_sum, _ = trace_inline_pallas_diff(
            scene, rays, rng_state, num_bounces=num_bounces, spp=spp,
            has_dielectric=has_dielectric, interpret=interpret,
        )
        return rad_sum / spp

    def sample(carry, _):
        rng = carry
        radiance, rng = trace_inline(
            scene, rays, rng, num_bounces, differentiable=True
        )
        return rng, radiance

    _, radiances = jax.lax.scan(sample, rng_state, None, length=spp)
    return jnp.mean(radiances, axis=0)


class SceneParams(NamedTuple):
    """EVERY continuous (differentiable) leaf of a Scene, as a flat pytree.

    Geometry: sphere pos/radius, plane pos/normal, box lo/hi, triangle
    v0/v1/v2.  Materials: color, illuminance, brdf_param of all four
    primitive kinds.  Only the integer BRDF kind tags stay in the
    template.  The plane normal trains on the unit sphere: it is stored
    raw here and renormalized inside `params_to_scene`, so an SGD update
    cannot produce a non-unit normal in the rebuilt scene.
    """

    sphere_pos: jnp.ndarray
    sphere_radius: jnp.ndarray
    sphere_color: jnp.ndarray
    sphere_illum: jnp.ndarray
    sphere_param: jnp.ndarray
    plane_pos: jnp.ndarray
    plane_normal: jnp.ndarray
    plane_color: jnp.ndarray
    plane_illum: jnp.ndarray
    plane_param: jnp.ndarray
    box_lo: jnp.ndarray
    box_hi: jnp.ndarray
    box_color: jnp.ndarray
    box_illum: jnp.ndarray
    box_param: jnp.ndarray
    tri_v0: jnp.ndarray
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_color: jnp.ndarray
    tri_illum: jnp.ndarray
    tri_param: jnp.ndarray


def scene_to_params(scene: Scene) -> SceneParams:
    return SceneParams(
        sphere_pos=scene.spheres.pos,
        sphere_radius=scene.spheres.radius,
        sphere_color=scene.spheres.material.color,
        sphere_illum=scene.spheres.material.illuminance,
        sphere_param=scene.spheres.material.brdf_param,
        plane_pos=scene.planes.pos,
        plane_normal=scene.planes.normal,
        plane_color=scene.planes.material.color,
        plane_illum=scene.planes.material.illuminance,
        plane_param=scene.planes.material.brdf_param,
        box_lo=scene.boxes.lo,
        box_hi=scene.boxes.hi,
        box_color=scene.boxes.material.color,
        box_illum=scene.boxes.material.illuminance,
        box_param=scene.boxes.material.brdf_param,
        tri_v0=scene.triangles.v0,
        tri_v1=scene.triangles.v1,
        tri_v2=scene.triangles.v2,
        tri_color=scene.triangles.material.color,
        tri_illum=scene.triangles.material.illuminance,
        tri_param=scene.triangles.material.brdf_param,
    )


def params_to_scene(params: SceneParams, template: Scene) -> Scene:
    """Rebuild a Scene from differentiable params + the template's
    non-differentiable fields (the BRDF kind tags).  No geometry is
    frozen: every continuous field comes from `params`."""
    from ..models.objects import Boxes, Triangles

    norm = jnp.sqrt(
        jnp.maximum(
            jnp.sum(params.plane_normal**2, axis=-1, keepdims=True), 1e-12
        )
    )
    return Scene(
        spheres=Spheres(
            pos=params.sphere_pos,
            radius=params.sphere_radius,
            material=Materials(
                color=params.sphere_color,
                illuminance=params.sphere_illum,
                brdf_kind=template.spheres.material.brdf_kind,
                brdf_param=params.sphere_param,
            ),
        ),
        planes=Planes(
            pos=params.plane_pos,
            normal=params.plane_normal / norm,
            material=Materials(
                color=params.plane_color,
                illuminance=params.plane_illum,
                brdf_kind=template.planes.material.brdf_kind,
                brdf_param=params.plane_param,
            ),
        ),
        boxes=Boxes(
            lo=params.box_lo,
            hi=params.box_hi,
            material=Materials(
                color=params.box_color,
                illuminance=params.box_illum,
                brdf_kind=template.boxes.material.brdf_kind,
                brdf_param=params.box_param,
            ),
        ),
        triangles=Triangles(
            v0=params.tri_v0,
            v1=params.tri_v1,
            v2=params.tri_v2,
            material=Materials(
                color=params.tri_color,
                illuminance=params.tri_illum,
                brdf_kind=template.triangles.material.brdf_kind,
                brdf_param=params.tri_param,
            ),
        ),
    )


def image_loss(
    params: SceneParams,
    template: Scene,
    camera: Camera,
    target: jnp.ndarray,
    rng_state: jnp.ndarray,
    num_bounces: int = 4,
    spp: int = 1,
    backend: str = "auto",
    has_dielectric: bool | None = None,
    estimator: str = "parity",
    interpret: bool = False,
    kinds=None,
) -> jnp.ndarray:
    """MSE between the rendered radiance image and a target — the inverse
    rendering objective."""
    scene = params_to_scene(params, template)
    h, w = target.shape[:2]
    img = render_radiance(
        scene, camera, rng_state, w, h, num_bounces, spp, backend,
        has_dielectric, estimator=estimator, interpret=interpret,
        kinds=kinds,
    )
    return jnp.mean((img - target) ** 2)


def loss_and_grad(params, template, camera, target, rng_state, **kw):
    return jax.value_and_grad(image_loss)(
        params, template, camera, target, rng_state, **kw
    )
