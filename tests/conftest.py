"""Test configuration: the suite runs on a virtual 8-device CPU mesh
unless ``JAX_PLATFORMS`` names another platform.

Must set env before the first jax import (SURVEY.md §4: multi-device
sharding is validated on forced host devices).  Tests marked ``gpu`` need
the card; the fixture below skips them elsewhere.  Run them on a GPU
machine with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from optix_renderer_tpu.utils.device import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
# the suite is compile-dominated (~40 jit configs): reruns reuse the cache
enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests when the default device is not a GPU."""
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
