"""Gradient correctness: autodiff pixel gradients vs central finite
differences (BASELINE.md north star: "gradients allclose vs finite
differences" for material / emission / geometry parameters)."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from haskell_path_tracer.diff import grad as G
from haskell_path_tracer.models.objects import (
    BRDF_GLOSSY,
    BRDF_MATTE,
    Camera,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops.rng import gen_seeds

import contextlib


@contextlib.contextmanager
def enable_x64():
    """x64 context manager across jax versions (jax.experimental.enable_x64
    was removed in jax 0.9; the config state object is the replacement)."""
    try:
        from jax.experimental import enable_x64 as _cm  # jax < 0.9
        with _cm():
            yield
    except ImportError:
        from jax._src.config import enable_x64 as _state
        with _state(True):
            yield


W, H, BOUNCES = 24, 16, 3


def small_scene():
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


def setup():
    scene = small_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=7)
    params = G.scene_to_params(scene)
    # target: render at perturbed params so the loss has nonzero gradient
    target = jnp.zeros((H, W, 3), jnp.float32) + 0.25
    loss = lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=BOUNCES
    )
    return params, loss


_F64_CACHE = {}


def setup_f64():
    """The same loss with a float64 forward pass — the well-conditioned
    ground truth for FD validation.  (In f32, FD noise at workable eps is
    a few percent — forward-pass rounding amplified by 1/eps — which says
    nothing about gradient correctness.)  Rays/RNG are constants w.r.t.
    the differentiated params, so casting rays + params to f64 makes the
    whole trace run in f64."""
    if _F64_CACHE:
        return _F64_CACHE["params"], _F64_CACHE["loss"]
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.models.objects import Rays
    from haskell_path_tracer.render.integrator import trace_inline

    scene = small_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    with enable_x64():
        rng = gen_seeds((H, W), seed=7)
        rays = primary_rays(cam, W, H)
        rays64 = Rays(
            origin=rays.origin.astype(jnp.float64),
            direction=rays.direction.astype(jnp.float64),
        )
        target = jnp.zeros((H, W, 3), jnp.float64) + 0.25
        params = G.scene_to_params(scene)
        params64 = type(params)(
            *[jnp.asarray(np.asarray(x, np.float64)) for x in params]
        )

        @jax.jit
        def loss64(p):
            s = G.params_to_scene(p, scene)
            rad, _ = trace_inline(s, rays64, rng, BOUNCES, differentiable=True)
            return jnp.mean((rad - target) ** 2)

        _F64_CACHE["params"] = params64
        _F64_CACHE["loss"] = loss64
    return params64, loss64


def central_fd(loss, params, field, idx, eps):
    arr = np.asarray(getattr(params, field)).copy()
    arr_p, arr_m = arr.copy(), arr.copy()
    arr_p[idx] += eps
    arr_m[idx] -= eps
    lp = float(loss(params._replace(**{field: jnp.asarray(arr_p)})))
    lm = float(loss(params._replace(**{field: jnp.asarray(arr_m)})))
    return (lp - lm) / (2 * eps)


def test_emission_gradient_matches_fd():
    params, loss = setup_f64()
    with enable_x64():
        g = jax.grad(loss)(params)
        for i in range(2):
            fd = central_fd(loss, params, "sphere_illum", (i,), 1e-3)
            ad = float(g.sphere_illum[i])
            np.testing.assert_allclose(ad, fd, rtol=2e-3, atol=1e-9)


def test_color_gradient_matches_fd():
    params, loss = setup_f64()
    with enable_x64():
        g = jax.grad(loss)(params)
        for idx in [(0, 0), (0, 2), (1, 1)]:
            fd = central_fd(loss, params, "sphere_color", idx, 1e-3)
            ad = float(g.sphere_color[idx])
            np.testing.assert_allclose(ad, fd, rtol=5e-3, atol=1e-9)


def test_brdf_param_gradient_matches_fd():
    params, loss = setup_f64()
    with enable_x64():
        g = jax.grad(loss)(params)
        fd = central_fd(loss, params, "sphere_param", (0,), 1e-3)
        np.testing.assert_allclose(
            float(g.sphere_param[0]), fd, rtol=5e-3, atol=1e-9
        )


def test_f32_gradient_matches_f64_gradient():
    """The production f32 gradient agrees with the f64 ground truth —
    closing the loop: f64 AD == f64 FD (above), f32 AD == f64 AD (here)."""
    params, loss = setup()
    g32 = jax.grad(loss)(params)
    params64, loss64 = setup_f64()
    with enable_x64():
        g64 = jax.grad(loss64)(params64)
    for field in ["sphere_illum", "sphere_color", "sphere_param"]:
        np.testing.assert_allclose(
            np.asarray(getattr(g32, field), np.float64),
            np.asarray(getattr(g64, field)),
            rtol=2e-2,
            atol=1e-6,
        )


def test_geometry_gradient_matches_fd_ops_level():
    """Geometry gradients validated where FD is well-conditioned: the
    intersection kernel.  (At image level, f32 FD noise swamps the small
    smooth geometry terms, and silhouette pixels carry visibility
    discontinuities that detached-decision AD deliberately ignores —
    SURVEY.md §7 "differentiate shading, not branching".)"""
    from haskell_path_tracer.ops.intersect import (
        plane_distances,
        sphere_distances,
    )
    from haskell_path_tracer.models.objects import make_planes, make_spheres

    o = jnp.zeros(3)
    d = jnp.asarray([0.0, 0.0, -1.0])

    base = make_spheres([[0.1, -0.2, 0.0]], [1.0], dummy_mats(1))

    def sphere_t(pos_z, radius):
        s = base.__class__(
            pos=base.pos.at[0, 2].set(pos_z),
            radius=base.radius.at[0].set(radius),
            material=base.material,
        )
        return sphere_distances(o, d, s)[0]

    for wrt, point, eps in [(0, (-6.0, 2.0), 1e-3), (1, (-6.0, 2.0), 1e-3)]:
        f = (lambda z: sphere_t(z, point[1])) if wrt == 0 else (
            lambda r: sphere_t(point[0], r)
        )
        x0 = point[wrt]
        ad = float(jax.grad(f)(jnp.float32(x0)))
        fd = (float(f(x0 + eps)) - float(f(x0 - eps))) / (2 * eps)
        np.testing.assert_allclose(ad, fd, rtol=1e-3, atol=1e-4)

    pbase = make_planes([[0.0, -3.0, 0.0]], [[0.0, 1.0, 0.0]], dummy_mats(1))

    def plane_t(py):
        p = pbase.__class__(
            pos=pbase.pos.at[0, 1].set(py),
            normal=pbase.normal,
            material=pbase.material,
        )
        return plane_distances(o, jnp.asarray([0.0, -1.0, 0.0]), p)[0]

    ad = float(jax.grad(plane_t)(jnp.float32(-3.0)))
    fd = (float(plane_t(-3.0 + 1e-3)) - float(plane_t(-3.0 - 1e-3))) / 2e-3
    np.testing.assert_allclose(ad, fd, rtol=1e-3)


def dummy_mats(n):
    return make_materials([([1.0, 1.0, 1.0], 0.0, BRDF_MATTE, 1.0)] * n)


def test_geometry_gradients_nonzero_at_image_level():
    """End-to-end, geometry params receive finite, nonzero gradients."""
    params, loss = setup()
    g = jax.grad(loss)(params)
    assert np.isfinite(np.asarray(g.sphere_pos)).all()
    assert np.abs(np.asarray(g.sphere_pos)).max() > 0
    assert np.abs(np.asarray(g.sphere_radius)).max() > 0


def test_inverse_rendering_recovers_emission():
    """Gradient descent on emission + color recovers a target render —
    the end-to-end proof that the gradients point the right way."""
    scene = small_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=3)
    true_params = G.scene_to_params(scene)
    target = G.render_radiance(
        G.params_to_scene(true_params, scene), cam, rng, W, H, BOUNCES
    )

    # Start from wrong emission; optimize it back.
    params = true_params._replace(
        sphere_illum=true_params.sphere_illum * 0.2
    )
    loss = lambda p: G.image_loss(p, scene, cam, target, rng, num_bounces=BOUNCES)
    l0 = float(loss(params))
    vg = jax.jit(jax.value_and_grad(loss))
    lr = 2.0
    for _ in range(60):
        l, g = vg(params)
        params = params._replace(
            sphere_illum=params.sphere_illum - lr * g.sphere_illum
        )
    l1 = float(loss(params))
    assert l1 < l0 * 0.02, f"loss {l0} -> {l1}"
    np.testing.assert_allclose(
        np.asarray(params.sphere_illum),
        np.asarray(true_params.sphere_illum),
        rtol=0.05,
        atol=0.02,
    )


def test_gradients_are_finite_everywhere():
    params, loss = setup()
    g = jax.grad(loss)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_plane_normal_gradient_matches_fd():
    """The plane normal is now a trainable leaf (renormalized in
    params_to_scene); its gradient must match f64 finite differences.
    FD here perturbs the RAW (pre-normalization) parameter, which is
    exactly what an optimizer updates.

    The camera pitches DOWN at the floor: with a level camera, horizon
    rays graze the plane (denom ~ 0) and tilting the normal flips their
    hit/miss decision — a visibility discontinuity whose FD artifact
    scales as 1/eps and which detached-decision AD deliberately ignores
    (SURVEY.md §7 "differentiate shading, not branching").  Away from
    grazing incidence AD == FD to ~9 digits."""
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.models.objects import Rays
    from haskell_path_tracer.render.integrator import trace_inline

    scene = small_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [-0.45, 0.0, 0.0], 90.0)
    with enable_x64():
        rng = gen_seeds((H, W), seed=7)
        rays = primary_rays(cam, W, H)
        rays64 = Rays(
            origin=rays.origin.astype(jnp.float64),
            direction=rays.direction.astype(jnp.float64),
        )
        base = G.scene_to_params(scene)
        params = type(base)(
            *[jnp.asarray(np.asarray(x, np.float64)) for x in base]
        )

        @jax.jit
        def loss(p):
            s = G.params_to_scene(p, scene)
            rad, _ = trace_inline(s, rays64, rng, BOUNCES,
                                  differentiable=True)
            return jnp.mean(rad)

        g = jax.grad(loss)(params)
        for idx in [(0, 0), (0, 2)]:
            fd = central_fd(loss, params, "plane_normal", idx, 1e-4)
            ad = float(g.plane_normal[idx])
            np.testing.assert_allclose(ad, fd, rtol=5e-3, atol=1e-9)
        assert np.abs(np.asarray(g.plane_normal)).max() > 0


def all_kinds_scene():
    from haskell_path_tracer.models.objects import (
        make_boxes,
        make_triangles,
    )

    base = small_scene()
    # Box overhead: the camera sees its bottom (lo.y) face and its front
    # (hi.z) face, so BOTH corners receive gradients through the slab t
    # (the entry face determines which corner parameterizes t_near).
    boxes = make_boxes(
        [[-2.0, 1.2, -12.0]],
        [[2.0, 3.0, -4.0]],
        make_materials([([0.9, 0.6, 0.3], 0.3, BRDF_MATTE, 1.0)]),
    )
    # Low-left triangle (clear of the overhead box and the spheres),
    # winding chosen so the geometric normal points UP (+y): one-sided
    # triangles show their front face to the camera above.
    tris = make_triangles(
        [[-4.0, -2.5, -4.5]],
        [[-1.5, -2.5, -4.5]],
        [[-2.8, -2.5, -6.5]],
        make_materials([([1.0, 0.9, 0.8], 4.0, BRDF_MATTE, 1.0)]),
    )
    return Scene(
        spheres=base.spheres, planes=base.planes, boxes=boxes,
        triangles=tris,
    )


def test_box_triangle_leaves_receive_gradients():
    """Every new SceneParams leaf (box corners, triangle vertices, their
    materials) gets a finite gradient through image_loss, and the
    shading-relevant ones are nonzero."""
    scene = all_kinds_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=11)
    params = G.scene_to_params(scene)
    target = jnp.zeros((H, W, 3), jnp.float32) + 0.25
    loss = lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=BOUNCES
    )
    g = jax.grad(loss)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    for field in [
        "box_lo", "box_hi", "box_color", "box_illum",
        "tri_v0", "tri_v1", "tri_v2", "tri_color", "tri_illum",
        "plane_normal",
    ]:
        assert np.abs(np.asarray(getattr(g, field))).max() > 0, field


def test_triangle_vertex_gradient_matches_fd_through_nee():
    """Triangle-vertex gradients through the physical/NEE estimator match
    finite differences.  The NEE light-sampling term (A * cos_l / d^2)
    depends smoothly and strongly on the emitter's vertices — the
    physically meaningful vertex-gradient path (in the parity estimator a
    uniform emitter's interior is vertex-independent; only its silhouette
    moves, which detached-decision AD deliberately ignores)."""
    from haskell_path_tracer.models.camera import primary_rays
    from haskell_path_tracer.render.nee import trace_physical

    scene = all_kinds_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=5)
    rays = primary_rays(cam, W, H)
    tp = G.scene_to_params(scene)

    def render(p):
        sc = G.params_to_scene(p, scene)
        rad, _ = trace_physical(
            sc, rays, rng, num_bounces=3, nee=True
        )
        return rad

    params = tp._replace(
        tri_illum=tp.tri_illum * 0.4,
        tri_v0=tp.tri_v0 + jnp.asarray([[0.15, 0.1, 0.15]]),
    )
    target = render(tp)
    loss = lambda p: jnp.mean((render(p) - target) ** 2)
    g = jax.grad(loss)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    # Every vertex component gets a nonzero, FD-matching gradient.
    for c in range(3):
        fd = central_fd(loss, params, "tri_v0", (0, c), 1e-3)
        ad = float(g.tri_v0[0, c])
        assert abs(ad) > 0
        np.testing.assert_allclose(ad, fd, rtol=0.05, atol=1e-6)
    # ... and the loss decreases along -grad (a genuine descent
    # direction, not just a number).
    l0 = float(loss(params))
    stepped = params._replace(
        tri_v0=params.tri_v0 - 10.0 * g.tri_v0,
        tri_illum=params.tri_illum - 10.0 * g.tri_illum,
    )
    assert float(loss(stepped)) < l0


def test_inverse_rendering_recovers_triangle_emission():
    """Gradient descent through image_loss recovers a triangle emitter's
    emission scale end-to-end (the triangle counterpart of
    test_inverse_rendering_recovers_emission).

    Vertex POSITIONS are differentiable (finite, FD-matching gradients —
    see test_triangle_vertex_gradient_matches_fd_through_nee) but not
    reliably *recoverable* by naive descent on an image loss: for a
    uniformly emissive triangle the loss near truth is dominated by
    silhouette terms that detached-decision AD ignores by design
    (SURVEY.md §7), and the remaining smooth part is non-convex.
    Recovering geometry through visibility boundaries needs
    edge-sampling / reparameterized integrators (PAPERS.md), which this
    framework documents as out of scope."""
    scene = all_kinds_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=5)
    true_params = G.scene_to_params(scene)
    target = G.render_radiance(
        G.params_to_scene(true_params, scene), cam, rng, W, H, BOUNCES
    )

    params = true_params._replace(tri_illum=true_params.tri_illum * 0.3)
    loss = lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=BOUNCES
    )
    l0 = float(loss(params))
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(120):
        _, g = vg(params)
        params = params._replace(
            tri_illum=params.tri_illum - 4.0 * g.tri_illum
        )
    l1 = float(loss(params))
    assert l1 < l0 * 0.05, f"loss {l0} -> {l1}"
    np.testing.assert_allclose(
        np.asarray(params.tri_illum),
        np.asarray(true_params.tri_illum),
        rtol=0.1,
    )


def test_image_loss_physical_estimator():
    """The public inverse-rendering API differentiates the production
    (physical/NEE) estimator: image_loss(estimator="physical") recovers
    the triangle emitter's emission via gradient descent."""
    scene = all_kinds_scene()
    cam = Camera.create([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=5)
    tp = G.scene_to_params(scene)
    target = G.render_radiance(
        G.params_to_scene(tp, scene), cam, rng, W, H, 3,
        estimator="physical",
    )
    params = tp._replace(tri_illum=tp.tri_illum * 0.3)
    loss = lambda p: G.image_loss(
        p, scene, cam, target, rng, num_bounces=3, estimator="physical"
    )
    l0 = float(loss(params))
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(120):
        _, g = vg(params)
        params = params._replace(
            tri_illum=params.tri_illum - 4.0 * g.tri_illum
        )
    l1 = float(loss(params))
    assert l1 < l0 * 0.05, (l0, l1)
    np.testing.assert_allclose(
        np.asarray(params.tri_illum), np.asarray(tp.tri_illum), rtol=0.1
    )


def big_sphere_scene(n=1000):
    """1000-sphere scene (the BASELINE config-4 class) for the physical
    gradient FD check."""
    rng = np.random.default_rng(7)
    pos = rng.uniform([-30, -2.5, -60], [30, 10, -8], (n, 3))
    radius = rng.uniform(0.2, 0.9, n)
    illum = np.where(rng.random(n) < 0.01, 50.0, 0.0)
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


@pytest.mark.parametrize("num_bounces", [1, 2])
def test_physical_gradient_fd_1k_spheres(num_bounces):
    """FD check of the physical gradient on a 1000-sphere scene (the
    chunked nearest-hit fold).  The objective is the mean radiance —
    LINEAR in an emitter's illuminance — so a central difference is exact
    up to f32 forward rounding."""
    scene = big_sphere_scene()
    cam = Camera.create([0.0, 2.0, 0.0], [0.2, 0.0, 0.0], 90.0)
    rng = gen_seeds((H, W), seed=3)
    params = G.scene_to_params(scene)
    light = int(np.argmax(np.asarray(params.sphere_illum)))

    def loss(p):
        s = G.params_to_scene(p, scene)
        img = G.render_radiance(
            s, cam, rng, W, H, num_bounces=num_bounces,
            estimator="physical",
        )
        return jnp.mean(img)

    g = jax.grad(loss)(params)
    ad = float(g.sphere_illum[light])
    eps = 0.5
    arr = np.asarray(params.sphere_illum).copy()
    arr_p, arr_m = arr.copy(), arr.copy()
    arr_p[light] += eps
    arr_m[light] -= eps
    fd = (
        float(loss(params._replace(sphere_illum=jnp.asarray(arr_p))))
        - float(loss(params._replace(sphere_illum=jnp.asarray(arr_m))))
    ) / (2 * eps)
    assert ad != 0.0
    np.testing.assert_allclose(ad, fd, rtol=2e-2)
