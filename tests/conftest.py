"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests need no accelerator: sharding correctness is validated on
host-platform virtual devices, and the GPU path is exercised by
``python chip_smoke.py`` on the card.
"""

import os

# Must be set before the first `import jax` anywhere in the test process.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the config too, so a process that imported jax before this file
# still runs the tests on the virtual CPU mesh.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
