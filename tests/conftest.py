"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices (the standard way to exercise
pjit/mesh code without TPU hardware) and with x64 enabled so the
float64 parity paths are real. Must run before jax is imported anywhere.
"""

import os

# Force CPU even if the ambient environment pins another platform
# (the unit tests need real float64 and virtual multi-device meshes).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The env var alone can be overridden by site-customized accelerator
# plugins registered before this file runs; the config update wins.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Some execution environments lower default-precision f32 matmuls to
# bf16 passes; the GP numerics in these tests require true f32/f64
# accumulation everywhere.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU (the PyTorch port's kernels); skipped when "
        "torch.cuda.is_available() is false",
    )
