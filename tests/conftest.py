"""Test configuration.

Tests run on a virtual 8-device CPU mesh (no accelerator required) so that
sharding tests exercise real collectives and float64 oracle parity is
available.  The platform is also forced through ``jax.config``, which
works even when jax was imported before this file ran.

Tests marked ``gpu`` need a card: the ``gpu_device`` fixture skips them
here (the decision is made when the test runs, never at import time), and
``python chip_smoke.py`` on the card covers what they check.  The suite
runs on the CPU unless ``JAX_PLATFORMS`` names another platform; on a GPU
machine, ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` runs
them.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
GPU_RUN = os.environ["JAX_PLATFORMS"] != "cpu"

import jax  # noqa: E402

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
# Persistent compile cache: the heavy receiver jits compile once per
# checkout instead of once per pytest run.
enable_compile_cache()
# Golden-model parity tests compare against float64 scipy oracles; enable
# x64 so tests can opt into exact-parity dtypes.  Production path is float32.
jax.config.update("jax_enable_x64", True)

if not GPU_RUN:
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) >= 8, \
        "need the 8-device virtual CPU mesh for sharding tests"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0x3D44)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu on a card; "
                    "python chip_smoke.py covers the same paths)")
    return devs[0]
