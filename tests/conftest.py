"""Test harness: force an 8-device CPU mesh so sharding tests run anywhere.

JAX collectives are backend-portable, so the multi-chip code paths are
validated on virtual CPU devices (the driver separately dry-runs the
multi-chip path); numerical parity tests also prefer CPU where float64 is
native.
"""

import os

# force-override: the ambient environment may pin JAX_PLATFORMS to a real
# accelerator; tests must stay host-local and deterministic.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# amortize XLA compiles across test runs
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def settings():
    from rl_mpc_lanemerging_tpu import Settings
    return Settings()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skips elsewhere")
