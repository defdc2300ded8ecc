"""Test configuration: run everything on a virtual 8-device CPU mesh.

Unit and integration tests are hermetic and multi-device capable: the
CPU backend with 8 virtual devices.  The compile cache follows the
package's rule (``gossamer_tpu._compile_cache_dir``).  Tests that need a
GPU carry the ``gpu`` marker and skip here; the ``gpu`` fixture decides
whether a card is present, never module import.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# the CPU unless the caller names a platform (the gpu-marked tests run
# with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import gossamer_tpu  # noqa: E402,F401  (enables x64 before jax.numpy loads)
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (run the ``gpu``-marked
    tests with ``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist
    tests/``)."""
    from gossamer_tpu.parallel.mesh import accelerator_present

    if not accelerator_present():
        pytest.skip("needs a GPU: JAX's default backend is "
                    f"{jax.default_backend()}")
