"""Chunked nearest-hit (large scenes) agrees exactly with the direct
formulation: same distances, same winning primitive (first-wins
tie-break), same payload — and gradients still flow.

The chunked path bounds the [rays, prims] intermediate that runs out of device memory at
1920x1088 x 1000 spheres (BASELINE.md config #4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from haskell_path_tracer.models.objects import (
    BRDF_MATTE,
    Scene,
    make_materials,
    make_planes,
    make_spheres,
)
from haskell_path_tracer.ops import intersect as I


def random_scene(n_spheres, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-10, -3, -30], [10, 8, -3], (n_spheres, 3))
    radius = rng.uniform(0.2, 1.2, n_spheres)
    mats = make_materials(
        [
            (rng.uniform(0.1, 1.0, 3).tolist(), float(i % 7 == 0),
             BRDF_MATTE, 1.0)
            for i in range(n_spheres)
        ]
    )
    s = make_spheres(pos.tolist(), radius.tolist(), mats)
    p = make_planes(
        [[0.0, -3.0, 0.0], [0.0, 9.0, 0.0]],
        [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
        make_materials(
            [([0.5, 0.5, 0.5], 0.0, BRDF_MATTE, 1.0)] * 2
        ),
    )
    return Scene(spheres=s, planes=p)


def random_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


def _assert_same_resolution(scene, o, d):
    """Chunked and direct formulations agree up to XLA fusion ulps (the
    two layouts may or may not emit FMAs for d2 = |l|^2 - tca^2, shifting
    t by ~1e-5 relative); the winning primitive must match wherever the
    nearest hit is unambiguous."""
    t_c, p_c = I._nearest_t_prim_chunked(o, d, scene)
    t_s, p_s = I._nearest_t_prim_small(o, d, scene)
    t_c, p_c = np.asarray(t_c), np.asarray(p_c)
    t_s, p_s = np.asarray(t_s), np.asarray(p_s)
    hit = t_s < I.INFINITE
    np.testing.assert_allclose(
        np.where(hit, t_c, 0.0), np.where(hit, t_s, 0.0), rtol=5e-5
    )
    np.testing.assert_array_equal(hit, t_c < I.INFINITE)
    # Where primitives disagree, the two candidates' distances must be
    # within ulp noise of each other (a genuine near-tie).
    disagree = hit & (p_c != p_s)
    assert (
        np.abs(t_c[disagree] - t_s[disagree])
        <= 5e-5 * np.abs(t_s[disagree]) + 1e-5
    ).all()
    assert disagree.mean() < 0.01


def test_chunked_matches_direct():
    # 300 spheres > CHUNKED_THRESHOLD (and not a multiple of CHUNK_SIZE,
    # exercising the padded tail).
    _assert_same_resolution(random_scene(300), *random_rays(4096))


def test_nearest_hit_dispatches_chunked():
    scene = random_scene(200)
    assert scene.num_primitives > I.CHUNKED_THRESHOLD
    o, d = random_rays(512)
    h = I.nearest_hit(o, d, scene)
    # Payload consistency: color/illum match a direct gather by prim.
    table = np.concatenate(
        [
            np.asarray(scene.spheres.material.color),
            np.asarray(scene.planes.material.color),
        ]
    )
    np.testing.assert_array_equal(
        np.asarray(h.color), table[np.asarray(h.prim)]
    )
    assert np.isfinite(np.asarray(h.normal)[np.asarray(h.hit)]).all()


def test_chunked_exact_chunk_multiple():
    # No padded tail.
    _assert_same_resolution(random_scene(I.CHUNK_SIZE * 2), *random_rays(1024))


def test_chunked_gradients_flow():
    scene = random_scene(150)
    o = jnp.zeros((8, 3), jnp.float32)
    # Aim straight at the first 8 sphere centers so every ray hits.
    centers = np.asarray(scene.spheres.pos)[:8]
    d = jnp.asarray(
        centers / np.linalg.norm(centers, axis=-1, keepdims=True),
        jnp.float32,
    )

    def f(pos):
        s = Scene(
            spheres=scene.spheres.__class__(
                pos=pos, radius=scene.spheres.radius,
                material=scene.spheres.material,
            ),
            planes=scene.planes,
        )
        h = I.nearest_hit(o, d, s)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    g = jax.grad(f)(scene.spheres.pos)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def _all_kinds_scene(num_prims):
    """Spheres plus two planes, a box and a triangle, `num_prims` in all."""
    import dataclasses

    from haskell_path_tracer.models.objects import make_boxes, make_triangles

    base = random_scene(num_prims - 4, seed=3)
    mat = make_materials([([0.6, 0.3, 0.2], 1.0, BRDF_MATTE, 1.0)])
    return dataclasses.replace(
        base,
        boxes=make_boxes([[-1.0, -1.0, -8.0]], [[1.0, 1.0, -6.0]], mat),
        triangles=make_triangles(
            [[-4.0, -2.0, -5.0]], [[4.0, -2.0, -5.0]], [[0.0, 4.0, -5.0]],
            mat,
        ),
    )


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_chunked_matches_direct_at_threshold(offset):
    """At CHUNKED_THRESHOLD - 1, +0 and +1 primitives, with every kind
    merged after the sphere chunks: the chunked fold and the direct fold
    resolve the same hits, and both payload forms (row gather and one-hot
    matmul) give the same hit record."""
    scene = _all_kinds_scene(I.CHUNKED_THRESHOLD + offset)
    assert scene.num_primitives == I.CHUNKED_THRESHOLD + offset
    o, d = random_rays(1024, seed=5)
    _assert_same_resolution(scene, o, d)
    t, prim = I._nearest_t_prim_small(o, d, scene)
    gather = I.hit_from_t_prim(o, d, t, prim, scene, use_gather=True)
    onehot = I.hit_from_t_prim(o, d, t, prim, scene, use_gather=False)
    for field in ("hit", "point", "normal", "color", "illuminance"):
        np.testing.assert_allclose(
            np.asarray(getattr(gather, field)),
            np.asarray(getattr(onehot, field)), rtol=1e-6, atol=1e-6,
            err_msg=field,
        )
