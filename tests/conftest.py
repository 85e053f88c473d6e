"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding tests spoof devices via
--xla_force_host_platform_device_count (SURVEY.md §4.6); numeric tests run in
float64-capable mode where needed via jax.config.

The suite runs on the CPU unless the caller names another platform in
``JAX_PLATFORMS`` (chip_smoke.py runs the tests marked ``gpu`` with
``JAX_PLATFORMS=cuda``). Whether a card is present is decided inside the
``gpu`` fixture, never at import time.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (tests marked ``gpu``)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run on the card through chip_smoke.py")
