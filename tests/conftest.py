"""Test configuration: run on CPU in float64 with a virtual 8-device mesh.

Accuracy gates (6SV1 / Natraj / HAPI) need float64. The 8 virtual CPU
devices let sharding tests validate the multi-device path without cards.

Tests that need an NVIDIA card carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them where JAX finds no GPU. On a machine with
a card they run with

    VSM_TESTS_ON_GPU=1 python -m pytest -m gpu tests/

which leaves JAX on its default (GPU) platform instead of the CPU.
"""
import os

import jax
import pytest

if os.environ.get("VSM_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (run with VSM_TESTS_ON_GPU=1 "
        "python -m pytest -m gpu tests/)")


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA card: run VSM_TESTS_ON_GPU=1 "
                    "python -m pytest -m gpu tests/ on a machine with one")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the live compiled-program set: with the full suite in one
    process, XLA:CPU segfaulted (deterministically) while compiling the
    first NamedSharding program after ~130 accumulated compilations
    (jax 0.9.0, 8 virtual devices). Dropping caches between modules keeps
    the compiler's live set small; per-module recompiles cost seconds."""
    yield
    jax.clear_caches()
