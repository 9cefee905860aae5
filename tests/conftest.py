"""Test configuration: force CPU with 8 virtual devices so sharding tests
run without TPU hardware. Must run before jax is imported anywhere."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


REFERENCE_ROOT = "/root/reference"


def reference_path(*parts) -> str:
    return os.path.join(REFERENCE_ROOT, *parts)


@pytest.fixture(scope="session")
def rfmip_file():
    p = reference_path(
        "examples/rfmip-clear-sky",
        "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc",
    )
    if not os.path.exists(p):
        pytest.skip("RFMIP input file not available")
    return p


@pytest.fixture(scope="session")
def lw_nn_both_file():
    p = reference_path("neural/data/lw-g128-210809_both_BEST.nc")
    if not os.path.exists(p):
        pytest.skip("LW NN model not available")
    return p


@pytest.fixture()
def rng():
    # function-scoped: every test gets identical, order-independent draws
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips elsewhere")
