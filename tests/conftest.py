import os

# Every test gets a deterministic virtual 8-device CPU mesh: XLA_FLAGS is
# read lazily at the first backend initialization, so setting it here works.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from radiativetransfer_sos_tpu.cache import enable_compile_cache  # noqa: E402

# The suite runs on the CPU backend (JAX_PLATFORMS=cpu).  The tests marked
# ``gpu`` run on the card through the ``gpu_device`` fixture
# (``python -m pytest -m gpu tests/`` on a GPU machine) and skip elsewhere.
jax.config.update("jax_enable_x64", True)
enable_compile_cache()


@pytest.fixture(scope="session")
def gpu_device():
    """The attached GPU, or skip.  Decided here, when a test asks for it —
    never while a module is imported or collected.  Tests wrap their
    computations in ``jax.default_device(gpu_device)``."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU attached")
