"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The unit tests run on the host CPU; sharding correctness is checked on
the virtual mesh. Tests that need a GPU carry the `gpu` marker and
skip through the `gpu_backend` fixture when there is none (the card
itself is exercised by chip_smoke.py).
"""

import os

# CPU unless the caller names platforms (the gpu-marked tests run on
# the card with JAX_PLATFORMS=cuda,cpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from libultrahdr_dev.utils import jaxcache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jaxcache.configure()


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided when the
    test runs, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")
    return jax.devices()[0]
