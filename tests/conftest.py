"""Test configuration: an 8-device virtual CPU mesh unless JAX_PLATFORMS says
otherwise.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`; multi-device sharding via
--xla_force_host_platform_device_count). Tests marked `gpu` need an NVIDIA GPU:
they skip on the CPU and run on the card with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's first device is "
                    f"{dev.platform}")
    return dev
