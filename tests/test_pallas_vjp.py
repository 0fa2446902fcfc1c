"""Differentiable Pallas megakernel (ops/pallas_megakernel_vjp.py), Triton route.

Validated three ways, all in interpret mode on CPU (same jnp ops through
the XLA CPU backend — see tests/test_pallas.py for the methodology):

  1. the custom-VJP forward is BIT-equal to the production forward kernel
     (it is the same pallas_call — callers that never differentiate pay
     nothing);
  2. gradients match `jax.grad` of the XLA differentiable integrator
     (render/integrator.py `differentiable=True`) for every parameter
     class — sphere position/radius, material color/illuminance, plane
     position, and the primary rays (camera derivatives) — computed in ONE
     combined grad call per path so each path compiles exactly once;
  3. gradients match central finite differences on an emission parameter
     (the same oracle diff/grad.py is validated against, BASELINE.md:25).

Decisions (hit masks, BRDF branches, RNG) are detached in BOTH paths, so
agreement is to float rounding except on the rare lanes where a
transcendental ulp flips a discrete decision; we compare with a
scale-normalized error bound for that reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from haskell_path_tracer.models.camera import primary_rays
from haskell_path_tracer.models.objects import (
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera,
    Rays,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops import rng as rng_ops
from haskell_path_tracer.ops.pallas_megakernel import trace_inline_pallas
from haskell_path_tracer.ops.pallas_megakernel_vjp import (
    trace_inline_pallas_diff,
)
from haskell_path_tracer.render.integrator import trace_inline

# Camera pitched down at the floor plane: every parameter class (including
# plane position) gets gradient signal, and no primary/secondary lane grazes
# a sphere tangentially — grazing lanes make the f32 gradient comparison
# ill-conditioned (d sqrt(r^2-d^2) explodes, amplifying last-ulp forward
# differences between backends into percent-level gradient noise).
H, W = 8, 16
B = 4
PITCH = -0.6


def _small_scene():
    # Same all-emissive scene as tests/test_grad.py: every surface both
    # emits and reflects, so every parameter class gets gradient signal
    # even at this tiny resolution / bounce budget.
    s = make_spheres(
        [[0.0, 0.0, -6.0], [2.5, 1.0, -5.0]],
        [2.0, 0.8],
        make_materials(
            [
                ([0.8, 0.4, 0.4], 2.0, BRDF_MATTE, 0.8),
                ([0.4, 0.4, 0.9], 0.5, BRDF_GLOSSY, 0.7),
            ]
        ),
    )
    p = make_planes(
        [[0.0, -3.0, 0.0]],
        [[0.0, 1.0, 0.0]],
        make_materials([([0.43, 0.95, 0.5], 0.1, BRDF_MATTE, 1.5)]),
    )
    return Scene(spheres=s, planes=p)


def _setup():
    scene = _small_scene()
    camera = Camera.create([0.0, 0.0, 0.0], [PITCH, 0.0, 0.0], 90.0)
    rays = primary_rays(camera, W, H)
    rng = rng_ops.gen_seeds((H, W), seed=0)
    wts = jax.random.normal(jax.random.PRNGKey(1), (H, W, 3))
    return scene, rays, rng, wts


def _rebuild(scene, pos, radius, color, illum, ppos):
    sp = dataclasses.replace(
        scene.spheres,
        pos=pos,
        radius=radius,
        material=dataclasses.replace(
            scene.spheres.material, color=color, illuminance=illum
        ),
    )
    pl = dataclasses.replace(scene.planes, pos=ppos)
    return dataclasses.replace(scene, spheres=sp, planes=pl)


def _norm_err(ga, gb):
    ga, gb = np.asarray(ga), np.asarray(gb)
    scale = np.abs(ga).max() + 1e-6
    return np.abs(ga - gb).max() / scale


def test_diff_forward_bit_equals_production_kernel():
    scene, rays, rng, _ = _setup()
    rad_d, rng_d = trace_inline_pallas_diff(
        scene, rays, rng, num_bounces=B, spp=2, interpret=True
    )
    rad_f, rng_f = trace_inline_pallas(
        scene, rays, rng, num_bounces=B, spp=2, interpret=True
    )
    assert (np.asarray(rad_d) == np.asarray(rad_f)).all()
    assert (np.asarray(rng_d) == np.asarray(rng_f)).all()


def test_all_parameter_grads_match_xla():
    scene, rays, rng, wts = _setup()
    leaves = (
        scene.spheres.pos,
        scene.spheres.radius,
        scene.spheres.material.color,
        scene.spheres.material.illuminance,
        scene.planes.pos,
        rays.origin,
        rays.direction,
    )
    names = (
        "sphere_pos",
        "sphere_radius",
        "color",
        "illuminance",
        "plane_pos",
        "ray_origin",
        "ray_direction",
    )

    def loss_xla(args):
        pos, radius, color, illum, ppos, ro, rd = args
        sc = _rebuild(scene, pos, radius, color, illum, ppos)
        rad, _ = trace_inline(
            sc, Rays(origin=ro, direction=rd), rng, B, differentiable=True
        )
        return jnp.sum(rad * wts)

    def loss_pl(args):
        pos, radius, color, illum, ppos, ro, rd = args
        sc = _rebuild(scene, pos, radius, color, illum, ppos)
        rad, _ = trace_inline_pallas_diff(
            sc,
            Rays(origin=ro, direction=rd),
            rng,
            num_bounces=B,
            spp=1,
            interpret=True,
        )
        return jnp.sum(rad * wts)

    gx = jax.grad(loss_xla)(leaves)
    gp = jax.grad(loss_pl)(leaves)
    for name, ga, gb in zip(names, gx, gp):
        assert np.abs(np.asarray(ga)).max() > 0, name  # non-degenerate
        err = _norm_err(ga, gb)
        assert err < 1e-2, (name, err)


def test_emission_grad_matches_finite_differences():
    scene, rays, rng, _ = _setup()
    illum0 = scene.spheres.material.illuminance

    def loss(illum):
        sp = dataclasses.replace(
            scene.spheres,
            material=dataclasses.replace(
                scene.spheres.material, illuminance=illum
            ),
        )
        sc = dataclasses.replace(scene, spheres=sp)
        rad, _ = trace_inline_pallas_diff(
            sc, rays, rng, num_bounces=B, spp=1, interpret=True
        )
        return jnp.mean(rad)

    g = jax.grad(loss)(illum0)
    # Radiance is LINEAR in each emission scalar along detached paths, so
    # central FD at any step is exact up to float rounding.
    eps = 0.5
    i = int(np.abs(np.asarray(g)).argmax())
    e = jnp.zeros_like(illum0).at[i].set(eps)
    fd = (loss(illum0 + e) - loss(illum0 - e)) / (2 * eps)
    assert np.abs(np.asarray(g)[i]) > 0
    np.testing.assert_allclose(float(fd), float(np.asarray(g)[i]), rtol=2e-3)


def _mixed_scene():
    """The sphere+plane fixture extended with a box and an emissive
    triangle, both camera-visible under the pitched-down camera."""
    from haskell_path_tracer.models.objects import (
        make_boxes,
        make_triangles,
    )

    scene = _small_scene()
    boxes = make_boxes(
        [[-3.0, -3.0, -5.5]],
        [[-1.2, -1.0, -3.5]],
        make_materials([([0.7, 0.6, 0.2], 0.3, BRDF_MATTE, 1.0)]),
    )
    tris = make_triangles(
        [[0.5, -2.9, -2.0]],
        [[3.5, -2.9, -2.5]],
        [[2.0, -1.0, -4.5]],
        make_materials([([0.3, 0.8, 0.8], 1.5, BRDF_MATTE, 1.0)]),
    )
    return dataclasses.replace(scene, boxes=boxes, triangles=tris)


def test_mixed_kind_forward_bit_equals_production_kernel():
    scene = _mixed_scene()
    _, rays, rng, _ = _setup()
    rad_d, rng_d = trace_inline_pallas_diff(
        scene, rays, rng, num_bounces=B, spp=2, interpret=True
    )
    rad_f, rng_f = trace_inline_pallas(
        scene, rays, rng, num_bounces=B, spp=2, interpret=True
    )
    assert (np.asarray(rad_d) == np.asarray(rad_f)).all()
    assert (np.asarray(rng_d) == np.asarray(rng_f)).all()


def test_box_and_triangle_grads_match_xla():
    """Gradients w.r.t. box corners and triangle vertices flow through
    the 16-column table packing."""
    scene = _mixed_scene()
    _, rays, rng, wts = _setup()
    leaves = (
        scene.boxes.lo,
        scene.boxes.hi,
        scene.triangles.v0,
        scene.triangles.v1,
        scene.triangles.v2,
        scene.triangles.material.illuminance,
    )
    names = ("box_lo", "box_hi", "tri_v0", "tri_v1", "tri_v2", "tri_illum")

    def rebuild(lo, hi, v0, v1, v2, t_il):
        bx = dataclasses.replace(scene.boxes, lo=lo, hi=hi)
        tr = dataclasses.replace(
            scene.triangles,
            v0=v0,
            v1=v1,
            v2=v2,
            material=dataclasses.replace(
                scene.triangles.material, illuminance=t_il
            ),
        )
        return dataclasses.replace(scene, boxes=bx, triangles=tr)

    def loss_xla(args):
        rad, _ = trace_inline(
            rebuild(*args), rays, rng, B, differentiable=True
        )
        return jnp.sum(rad * wts)

    def loss_pl(args):
        rad, _ = trace_inline_pallas_diff(
            rebuild(*args), rays, rng, num_bounces=B, spp=1, interpret=True
        )
        return jnp.sum(rad * wts)

    gx = jax.grad(loss_xla)(leaves)
    gp = jax.grad(loss_pl)(leaves)
    for name, ga, gb in zip(names, gx, gp):
        if not name.startswith("box"):
            # Triangles carry first-order signal (normal and t are smooth
            # functions of the vertices).  Box FACE normals are
            # sign()-piecewise-constant in BOTH paths, so box corners get
            # only indirect (often zero) gradient at this tiny resolution
            # — equality below is still the contract.
            assert np.abs(np.asarray(ga)).max() > 0, name
        err = _norm_err(ga, gb)
        assert err < 2e-2, (name, err)
