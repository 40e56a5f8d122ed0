"""Test configuration: CPU backend with 8 virtual devices, x64 enabled.

Mirrors the reference's test philosophy (SURVEY.md §4): tests run the real operators and
solvers and validate them numerically against analytical and dense oracles.  The virtual
8-device mesh gives the distributed coverage the reference never had (its MPI paths were
validated only operationally).

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip elsewhere; the decision is
made in a fixture, at run time.  On a machine with a card they run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import re

# The suite forces the CPU backend unless JAX_PLATFORMS names another one.  Must be set
# before the first jax backend initialization.
_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if _ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # force EXACTLY 8 virtual devices, overriding any pre-existing count (a CI image with
    # device_count=4 would otherwise fail every test on the device-count assert)
    flags = os.environ.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


@pytest.fixture(scope="session", autouse=True)
def _verify_virtual_devices():
    if jax.default_backend() == "cpu":
        assert jax.device_count() == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests where JAX found no GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
