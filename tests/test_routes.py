"""The capability function (ops/routes.py), the user-facing options that go
through it, the compile-cache helper, and the refusal of chip_smoke.py and
bench.py to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from haskell_path_tracer.ops import routes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "family, platform, route",
    [
        ("parity", "cpu", "xla"),
        ("parity_grad", "cpu", "xla"),
        ("physical", "cpu", "xla"),
        ("split", "cpu", "xla"),
        ("parity", "gpu", "triton"),
        ("parity_grad", "gpu", "triton"),
        ("physical", "gpu", "xla"),
        ("split", "gpu", "xla"),
    ],
)
def test_fast_route(family, platform, route):
    assert routes.fast_route(family, platform) == route


def test_fast_route_defaults_to_jax_backend():
    assert routes.fast_route("parity") == routes.fast_route(
        "parity", jax.default_backend()
    )


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown estimator family"):
        routes.fast_route("bidirectional", "gpu")


@pytest.mark.parametrize(
    "requested, family, platform, interpret, expected",
    [
        ("auto", "parity", "cpu", False, False),
        ("auto", "parity", "gpu", False, True),
        ("xla", "parity", "gpu", False, False),
        ("pallas", "parity", "gpu", False, True),
        ("pallas", "parity", "cpu", True, True),  # tests only
    ],
)
def test_use_kernel(requested, family, platform, interpret, expected):
    assert routes.use_kernel(requested, family, platform, interpret) is expected


@pytest.mark.parametrize(
    "requested, family, platform",
    [
        ("pallas", "parity", "cpu"),
        ("pallas", "parity_grad", "cpu"),
        ("pallas", "physical", "gpu"),
        ("pallas", "split", "gpu"),
    ],
)
def test_explicit_pallas_without_kernel_raises(requested, family, platform):
    with pytest.raises(ValueError, match="no Pallas kernel"):
        routes.use_kernel(requested, family, platform)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        routes.use_kernel("mosaic", "parity", "gpu")


def test_renderer_explicit_pallas_raises_on_cpu():
    from haskell_path_tracer.render.renderer import Renderer
    from haskell_path_tracer.utils.config import RenderConfig

    with pytest.raises(ValueError, match="no Pallas kernel"):
        Renderer(RenderConfig(width=8, height=8, kernel="pallas"))


@pytest.mark.parametrize("estimator", ["parity", "physical"])
def test_render_radiance_explicit_pallas_raises_on_cpu(estimator):
    from haskell_path_tracer.diff.grad import render_radiance
    from haskell_path_tracer.models import world
    from haskell_path_tracer.ops.rng import gen_seeds

    with pytest.raises(ValueError, match="no Pallas kernel"):
        render_radiance(
            world.main_scene(), world.initial_camera(), gen_seeds((4, 4), 0),
            4, 4, num_bounces=1, backend="pallas", estimator=estimator,
        )


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    from haskell_path_tracer.utils import compile_cache

    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.configure()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_leaves_env_alone(monkeypatch, tmp_path, cache_config):
    from haskell_path_tracer.utils import compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing.
    assert jax.config.jax_compilation_cache_dir is None


def _run_script(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_cpu():
    _assert_refused(_run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT))


def test_chip_smoke_refuses_without_repo(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    _assert_refused(_run_script(str(tmp_path / "chip_smoke.py"), tmp_path))


def test_bench_refuses_cpu():
    proc = _run_script(os.path.join(ROOT, "bench.py"), ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
