"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so that the
numerics can be compared against numpy/sklearn float64 references.  The
``gpu``-marked goldens (``tests/test_gpu_goldens.py`` and a few large-N
cases elsewhere) run on a GPU with
``GPT_GPU_TESTS=1 python -m pytest tests/ -q -m gpu``.
"""
import os
import sys

# Must be set before jax initializes any backend; the platform is forced
# through jax.config after importing jax, which wins over plugins.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# GPT_GPU_TESTS=1 leaves the default (GPU) backend in place so the
# gpu-marked goldens run:  GPT_GPU_TESTS=1 pytest -m gpu
if not os.environ.get("GPT_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference repo not mounted"
)


@pytest.fixture
def gpu():
    """The GPU device, or a skip: decided at test time, never at import."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: GPT_GPU_TESTS=1 python -m pytest -m gpu")
    return jax.devices()[0]
