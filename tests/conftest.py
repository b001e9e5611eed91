"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharded-vs-single-device comparisons run on 8 virtual CPU devices;
tests that need the GPU carry the ``gpu`` marker and skip here (the
``gpu`` fixture decides, at run time, whether a card is present).
The persistent compilation cache is placed by ``import ksfd_tpu``.
"""

import os

# CPU unless the caller names a platform (JAX_PLATFORMS=cuda runs the
# gpu-marked tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end gate tests"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run: python chip_smoke.py")
