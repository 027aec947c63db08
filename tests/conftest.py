"""Test configuration: run on a virtual 8-device CPU mesh by default.

Sharding tests use xla_force_host_platform_device_count=8 for their
meshes. The platform goes through jax.config, after jax's import: it is
JAX_PLATFORMS when set (`JAX_PLATFORMS=cuda` runs the `gpu`-marked tests on
the card), else the CPU. Tests that need the card decide inside the
`gpu_device` fixture — never at import — and skip elsewhere."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
