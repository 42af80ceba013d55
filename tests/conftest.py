"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-device (consensus/shard_map) tests emulate a mesh without a real
accelerator, as described in SURVEY.md section 4.  XLA_FLAGS must be set
before jax initialises its backends; the platform is pinned through
jax.config so the suite stays on the CPU even where a GPU is visible.

Tests marked ``gpu`` need the card: they take the ``gpu_devices`` fixture,
which skips them here.  ``python chip_smoke.py`` runs their checks on the
GPU in its own process.
"""
import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# float64 on CPU lets LAD/BP run at the reference's double precision;
# solvers that default to float32 are explicit about it and unaffected.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on the CPU test backend")


@pytest.fixture
def gpu_devices():
    """The GPU devices, or a skip.  Decided here, at run time, never at
    collection: every xdist worker must collect the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run: python chip_smoke.py)")
    return devices


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The full suite compiles ~300 distinct XLA programs; with all of
    them kept loaded, the CPU JIT segfaults inside
    ``backend_compile_and_load`` near the end of the run (reproduced
    twice at tests/test_weights.py, the alphabetically last module;
    every module passes in isolation).  Modules share almost no shapes,
    so per-module clearing costs little and bounds live executables."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(123)


def make_regression(rng, n, p, *, noise=1.0, mean=0.0, sd=1.0,
                    intercept=5.0, sparse=False):
    """Seeded test problem in the style of the reference README examples."""
    b = rng.uniform(size=p)
    if sparse:
        mask = rng.uniform(size=p) < 0.3
        b = b * mask
    X = rng.normal(mean, sd, (n, p))
    y = intercept + X @ b + noise * rng.normal(size=n)
    return X, y, b
