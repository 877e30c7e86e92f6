"""Test config: run everything on a virtual 8-device CPU mesh so sharding
tests work without an accelerator (SURVEY.md §4 'multi-device tests runnable
on CPU via xla_force_host_platform_device_count').

jax.config.update runs before any device use, so the tests stay on the CPU
whatever JAX_PLATFORMS the environment sets. The GPU paths run through
`python chip_smoke.py` on a machine with a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _cpu_mesh_guard():
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == 8
    yield


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(123)
