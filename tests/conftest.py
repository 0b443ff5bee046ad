"""Test environment: the CPU backend (unless ``JAX_PLATFORMS`` says
otherwise), 8 virtual CPU devices for mesh tests, float64, and the
scan-friendly XLA flags — all before the first jax import.

Tests marked ``gpu`` need the card and skip elsewhere; run them on a GPU
machine with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# NaN sanitizer in test mode (SURVEY §5): any computation returning NaN
# fails loudly.  Tests that inject NaNs on purpose (defensive culling)
# opt out locally with `with jax.debug_nans(False): ...`.
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module: a full-suite run
    accumulates ~600 XLA:CPU programs in one process and the compiler
    segfaults deterministically around the 144th test (inside
    backend_compile_and_load); dropping the caches at module boundaries
    keeps the process within whatever resource the compiler exhausts.
    Costs a few shared recompiles per module."""
    yield
    jax.clear_caches()


@pytest.fixture()
def gpu():
    """The GPU device for tests marked ``gpu``; skips without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform!r}")
    return dev


@pytest.fixture()
def eight_devices():
    """The 8 devices mesh tests shard over; skips with fewer."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip(f"needs 8 (virtual) devices, have {len(devs)}")
    return devs[:8]


REFERENCE_PATH = "/root/reference"


def has_reference() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_PATH, "lib"))


@pytest.fixture(scope="session")
def reference_libprop():
    """The actual NumPy reference, imported as a parity oracle (read-only)."""
    if not has_reference():
        pytest.skip("reference implementation not available")
    sys.path.insert(0, REFERENCE_PATH)
    import lib.libprop as lprop

    return lprop


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
