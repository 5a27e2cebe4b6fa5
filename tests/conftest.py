"""Test harness configuration.

By default tests run on CPU with 8 virtual devices so that mesh/sharding
logic and multi-chip code paths are exercised without TPU hardware
(SURVEY.md §4.2 item 4).  Pallas kernels automatically fall back to
interpreter mode off-TPU (see qnx.kernels.xnor_gemm._interpret_default).

Set ``QNX_TEST_TPU=1`` to run the suite on the real TPU instead (single
chip; sharding tests that need >1 device will skip).
"""
import os

import jax
import pytest

if os.environ.get("QNX_TEST_TPU", "0") != "1":
    # Must run before any backend is initialized. Note: env vars are NOT
    # enough here — the TPU plugin in this image force-updates
    # jax_platforms at interpreter boot, so we override via jax.config.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def n_devices():
    return jax.device_count()


def require_devices(n):
    return pytest.mark.skipif(
        jax.device_count() < n, reason=f"needs >= {n} devices"
    )
