"""Test configuration: run the tests on a virtual 8-device CPU mesh.

The environment is set before JAX initialises its backends, so this module
does the setup at import time (pytest imports conftest before any test
module). Multi-device sharding tests rely on the 8 virtual devices. Tests
that need the GPU take the ``gpu`` fixture and carry the ``gpu`` marker;
``chip_smoke.py`` runs them on the card, in its own process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from complex_prompt_diffusion_tpu.device import enable_compile_cache  # noqa: E402

# Pin full f32 matmul precision so numerics tests compare against exact
# products, whatever the backend's default.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache shared across test runs.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """The first device, or a skip when it is not a GPU (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; runs on the card through chip_smoke.py")
    return dev
