"""The package's former import name: an alias package beside
`haskell_path_tracer` that maps every import onto the real modules."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

import haskell_path_tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = [
    m.name for m in pkgutil.iter_modules([ROOT])
    if m.ispkg and m.name.startswith("haskell_path_tracer_")
]


def _import_alias(name):
    with pytest.warns(DeprecationWarning, match="haskell_path_tracer"):
        sys.modules.pop(name, None)
        return importlib.import_module(name)


def test_one_alias_package():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_is_the_package(alias):
    assert _import_alias(alias) is haskell_path_tracer


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize(
    "sub", ["render.renderer", "diff.grad", "ops.routes", "models.objects"]
)
def test_alias_submodule_is_the_real_module(alias, sub):
    _import_alias(alias)
    real = importlib.import_module(f"haskell_path_tracer.{sub}")
    assert importlib.import_module(f"{alias}.{sub}") is real
    assert real.__spec__.name == f"haskell_path_tracer.{sub}"


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_runs_the_cli(alias, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", f"{alias}.app.main", "--help"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--variant" in proc.stdout
