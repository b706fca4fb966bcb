"""Test harness config: an 8-device virtual CPU mesh so sharding tests run
anywhere (shardings are validated on xla_force_host_platform_device_count=8).

The tests run on the CPU unless JAX_PLATFORMS says otherwise; the `gpu`
marked tests need `JAX_PLATFORMS=cuda,cpu` on a machine with a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
