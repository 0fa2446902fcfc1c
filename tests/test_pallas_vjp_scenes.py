"""The fused fwd+bwd parity kernel (interpret mode) against `jax.grad` of
the XLA path, through the public gradient API (`diff/grad.py`), on every
scene class and on an image whose pixel count leaves a masked tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nee_scenes
from haskell_path_tracer.diff import grad as G
from haskell_path_tracer.models import world
from haskell_path_tracer.models.objects import Camera
from haskell_path_tracer.ops.rng import gen_seeds

DOWN = Camera.create([0.0, 0.0, 0.0], [-0.6, 0.0, 0.0], 90.0)


def _mixed():
    from test_pallas_vjp import _mixed_scene

    return _mixed_scene()


CASES = {
    "reference": (world.main_scene, world.initial_camera, 16, 8),
    "mixed_kinds": (_mixed, lambda: DOWN, 16, 8),
    "glass": (nee_scenes.glassy, lambda: DOWN, 16, 8),
    "cornell8": (nee_scenes.cornell8, world.initial_camera, 16, 8),
    "odd_width": (world.main_scene, world.initial_camera, 13, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_grads_match_xla(name):
    make_scene, make_cam, w, h = CASES[name]
    scene, cam = make_scene(), make_cam()
    params = G.scene_to_params(scene)
    rng = gen_seeds((h, w), seed=0)
    wts = jax.random.normal(jax.random.PRNGKey(1), (h, w, 3))

    def loss(p, backend):
        img = G.render_radiance(
            G.params_to_scene(p, scene), cam, rng, w, h, num_bounces=2,
            backend=backend, interpret=backend == "pallas",
        )
        return jnp.sum(img * wts)

    lx, gx = jax.value_and_grad(loss)(params, "xla")
    lp, gp = jax.value_and_grad(loss)(params, "pallas")
    np.testing.assert_allclose(float(lp), float(lx), rtol=1e-5, atol=1e-6)
    nonzero = 0
    for field in G.SceneParams._fields:
        a = np.asarray(getattr(gx, field))
        b = np.asarray(getattr(gp, field))
        if not a.size:
            continue
        scale = np.abs(a).max() + 1e-6
        assert np.abs(a - b).max() / scale < 1e-2, field
        nonzero += int(np.abs(a).max() > 0)
    assert nonzero >= 3  # the comparison is not vacuous
