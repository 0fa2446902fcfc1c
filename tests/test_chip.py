"""The Pallas kernels compiled for the GPU (Triton), against XLA on the same
card.  Marked `chip`: they skip on the CPU (a Triton kernel has no
compiled form there; tests/test_pallas*.py cover the same code in
interpret mode) and run on a GPU machine through `python chip_smoke.py`
or `pytest -m chip tests/test_chip.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nee_scenes
from haskell_path_tracer.diff import grad as G
from haskell_path_tracer.models import world
from haskell_path_tracer.models.objects import Camera
from haskell_path_tracer.ops.rng import gen_seeds
from haskell_path_tracer.render.integrator import (
    make_accumulator,
    render_batch_inline,
    render_batch_pallas,
)
from haskell_path_tracer.render.renderer import Renderer
from haskell_path_tracer.utils.config import RenderConfig

pytestmark = pytest.mark.chip

DOWN = Camera.create([0.0, 0.0, 0.0], [-0.6, 0.0, 0.0], 90.0)
MIN_LANE_SHARE = 0.995  # PARITY.md's knife-edge contract


def _mixed():
    from test_pallas_vjp import _mixed_scene

    return _mixed_scene()


SCENES = {
    "reference": (world.main_scene, world.initial_camera),
    "mixed_kinds": (_mixed, lambda: DOWN),
    "glass": (nee_scenes.glassy, lambda: DOWN),
    "cornell8": (nee_scenes.cornell8, world.initial_camera),
}


def _lane_shares(a, b):
    rng_eq = (np.asarray(a.rng) == np.asarray(b.rng)).all(-1).mean()
    close = np.isclose(np.asarray(a.color), np.asarray(b.color), rtol=1e-5,
                       atol=1e-6).all(-1).mean()
    return rng_eq, close


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compiled_forward_matches_xla(gpu, name):
    make_scene, make_cam = SCENES[name]
    scene, cam = make_scene(), make_cam()
    w, h = 257, 129  # not a multiple of the lane block: a masked tail
    ref = jax.jit(lambda a: render_batch_inline(
        scene, cam, a, 2, num_bounces=4))(make_accumulator(w, h, seed=5))
    out = jax.jit(lambda a: render_batch_pallas(
        scene, cam, a, 2, num_bounces=4))(make_accumulator(w, h, seed=5))
    rng_eq, close = _lane_shares(ref, out)
    assert rng_eq >= MIN_LANE_SHARE and close >= MIN_LANE_SHARE, (
        rng_eq, close)


def test_renderer_kernel_matches_xla_at_cli_defaults(gpu):
    """The CLI's default shape (800x600, 15 bounces) through `Renderer`."""
    scene, cam = world.main_scene(), world.initial_camera()
    accs = {}
    for kernel in ("pallas", "xla"):
        r = Renderer(RenderConfig(kernel=kernel, seed=0))
        accs[kernel] = r.step(scene, cam, r.init_accumulator(seed=0), spp=2)
    rng_eq, close = _lane_shares(accs["xla"], accs["pallas"])
    assert rng_eq >= MIN_LANE_SHARE and close >= MIN_LANE_SHARE, (
        rng_eq, close)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compiled_grads_match_xla(gpu, name):
    make_scene, make_cam = SCENES[name]
    scene, cam = make_scene(), make_cam()
    w, h = 67, 33
    rng = gen_seeds((h, w), seed=0)
    wts = jax.random.normal(jax.random.PRNGKey(1), (h, w, 3))

    def loss(p, backend):
        img = G.render_radiance(G.params_to_scene(p, scene), cam, rng, w, h,
                                num_bounces=3, spp=2, backend=backend)
        return jnp.sum(img * wts)

    params = G.scene_to_params(scene)
    gx = jax.jit(jax.grad(lambda p: loss(p, "xla")))(params)
    gk = jax.jit(jax.grad(lambda p: loss(p, "pallas")))(params)
    for field in G.SceneParams._fields:
        a = np.asarray(getattr(gx, field))
        b = np.asarray(getattr(gk, field))
        if a.size:
            # The tolerance of the interpret-mode tests
            # (tests/test_pallas_vjp_scenes.py).
            scale = np.abs(a).max() + 1e-6
            assert np.abs(a - b).max() / scale < 1e-2, field
