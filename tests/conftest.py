"""Test harness configuration.

Tests run on a forced 8-device CPU mesh: sharding tests exercise real
`Mesh` / `shard_map` partitioning on virtual host devices, and everything
is deterministic and fast.  The one exception is a run that selects the
`chip` marker (`pytest -m chip`, as chip_smoke.py does on a GPU machine):
it keeps JAX's default platform so those tests reach the card.  Tests
marked `chip` skip themselves (the `gpu` fixture) when JAX finds no GPU.
"""

import os

import numpy as np
import pytest


def _chip_run(config) -> bool:
    return "chip" in (config.getoption("markexpr", "") or "").replace(
        "not chip", ""
    )


def pytest_configure(config):
    if _chip_run(config):
        return
    # Must happen before any JAX backend initializes (collection imports
    # test modules, but nothing computes until a test runs).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU, or a skip when JAX finds none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return jax.devices()[0]
