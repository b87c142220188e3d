"""Root conftest: configure JAX for testing BEFORE any test imports it.

Tests run on a virtual 8-device CPU mesh (multi-device sharding checks
without accelerators) in float64 (dense-oracle numerical parity with the
float64 reference).

Tests marked ``gpu`` need a GPU and skip elsewhere. To run them on a
machine with one, opt out of the CPU pin:

    RUNLMC_TEST_GPU=1 python -m pytest tests/test_chip.py -m gpu -q
"""

import os

_ON_GPU = os.environ.get("RUNLMC_TEST_GPU") == "1"

if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips without one (run with RUNLMC_TEST_GPU=1)",
    )
