"""Test configuration: virtual 8-device CPU mesh, fp64 enabled.

Must run before jax is imported anywhere — hence plain env mutation at
module import time (pytest imports conftest first).  ``JAX_PLATFORMS``
defaults to the CPU; the ``gpu``-marked tests run on the card when the
suite is started with ``JAX_PLATFORMS=cuda`` (see README).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def fixture_mtx():
    return os.path.join(os.path.dirname(__file__), "..", "data", "test.mtx")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
    return dev


@pytest.fixture
def multi_device():
    """Skips the test unless at least two devices are present."""
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
