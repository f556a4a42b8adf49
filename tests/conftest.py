"""Test configuration: the CPU with a virtual 8-device mesh.

Unit tests run on the CPU, so the sharding code paths are exercised
everywhere. The one exception is ``python -m pytest tests -m gpu``, which
selects the tests that need an NVIDIA GPU and leaves JAX its default
platform; elsewhere those tests skip (see the ``gpu_device`` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest

REFERENCE_DATA = pathlib.Path("/root/reference/tests")


def pytest_configure(config):
    if (config.getoption("markexpr") or "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided per test, at run
    time, so every worker collects the same tests)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest tests -m gpu` on one")
    return devices[0]


def reference_data_dir() -> pathlib.Path:
    if not REFERENCE_DATA.exists():
        pytest.skip("reference test data not available")
    return REFERENCE_DATA
