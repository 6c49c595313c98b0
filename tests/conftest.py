"""Test configuration: pick the JAX platform BEFORE importing jax.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
tests have a mesh (--xla_force_host_platform_device_count).  The
``gpu``-marked tests run on a card with ``TFHE_TEST_PLATFORM=cuda`` (see
chip_smoke.py) and skip elsewhere.
"""

import os

# force-assign (not setdefault): an ambient JAX_PLATFORMS must not move the
# CPU suite onto another platform
os.environ["JAX_PLATFORMS"] = os.environ.get("TFHE_TEST_PLATFORM", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# set the platform through jax.config as well: it wins over anything that
# configured jax before this file ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x7F4E)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time, so
    every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs on the card via chip_smoke.py")


def pytest_configure(config):
    # wrapping mod-2^32 arithmetic intentionally overflows NumPy scalars
    config.addinivalue_line(
        "filterwarnings", "ignore:overflow encountered:RuntimeWarning"
    )
