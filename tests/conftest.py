"""Test configuration: CPU JAX with a virtual 8-device mesh and x64.

The suite runs on the host CPU (JAX_PLATFORMS=cpu, which this file also
sets in-process): sharding is validated on a host-platform 8-device mesh,
numeric comparisons against the oracle run the engine in 'exact'
(f64-phase) mode, and Pallas kernels run in interpret mode.

Tests marked `gpu` need the card (a Triton build, a GPU-only path); they
skip here, and chip_smoke.py runs those paths on a GPU.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU backend; skipped elsewhere "
                   "(chip_smoke.py runs these paths on the card)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None and \
            jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")
