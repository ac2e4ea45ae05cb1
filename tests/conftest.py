"""Test environment: the CPU with 8 virtual devices, unless told otherwise.

The reference test suite requires a CUDA GPU and skips otherwise
(tests/test_render.py:18-22 there). Ours runs anywhere: pure-JAX oracles and
the Pallas kernels' interpreter on the CPU, and the multi-device sharding
logic on an XLA-faked 8-device host (SURVEY.md section 4).

Tests marked ``chip`` need an NVIDIA GPU. They skip on the CPU; run them on
a card with ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``. Whether
a card is present is decided in the ``gpu`` fixture, never at import time,
so every pytest-xdist worker collects the same tests.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402


@pytest.fixture
def gpu():
    """The first device, skipping the test when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda python -m "
                    "pytest -m chip tests/)")
    return dev


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch, tmp_path_factory):
    """Example CLIs run in-process call utils.runtime.enable_compile_cache.
    With the variable set, that helper leaves JAX's configuration alone (JAX
    read the variable at import, before it was set), so no test turns on a
    persistent cache for the rest of its worker."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path_factory.getbasetemp() / "jax_cache"))
