"""Tests run on the CPU, on a virtual 8-device mesh, so sharding paths are
exercised without a GPU. With MI_GPU_TESTS=1 the suite keeps JAX's default
platform instead, which is how the `gpu`-marked tests run on the card:

    MI_GPU_TESTS=1 python -m pytest tests -m gpu

Whether a card is there is decided per test, inside the `_gpu_only`
fixture, never while a module is imported.
"""
import os

import pytest

os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

if not os.environ.get("MI_GPU_TESTS"):
    import jax
    jax.config.update("jax_platforms", "cpu")

# expose the package's reference-parity test fixtures (mi.test.util)
from mitsuba3dopplertof_tpu.test.util import tmpfile  # noqa: F401,E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with MI_GPU_TESTS=1 on the "
                    "card, see README)")
