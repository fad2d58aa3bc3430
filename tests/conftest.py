import os

import pytest

# Tests run on a virtual 8-device CPU mesh (JAX_PLATFORMS=cpu); the GPU is
# exercised by chip_smoke.py and by the tests marked ``gpu``.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none.  Decided
    here, at run time, never while a module is imported."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
    return devices[0]
