"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax is first imported anywhere in the test
process (SURVEY.md §4 / task environment notes).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); the test skips itself when torch sees no card")


@pytest.fixture
def rng():
    return np.random.RandomState(1234)
