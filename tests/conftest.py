"""Test configuration: run the suite on CPU with fp64 and 8 virtual devices.

Correctness tests need fp64 (the 1e-8 stabilized-G gate, SURVEY.md §7) and
a multi-device mesh for the parallel-tempering/sharding tests (SURVEY.md §5
implication (f)). What needs the GPU is checked on the card by
chip_smoke.py; tests marked ``gpu`` skip here.

jax.config.update is used instead of environment variables because JAX may
already be imported when this file runs; it works as long as no backend
has been initialized yet.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """Skip the test unless JAX finds an NVIDIA GPU (decided when the test
    runs, never at import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the card")
    return jax.devices()[0]
