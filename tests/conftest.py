"""Test configuration: tests run on the CPU, on an 8-device virtual mesh.

Multi-device sharding tests (SURVEY.md section 4.4) run on fake CPU devices
via XLA's host-platform device-count override — the standard JAX pattern for
testing `shard_map`/`ppermute` code without several accelerators. Must be
set before JAX initializes, hence here in conftest at import time.

Tests that need a GPU carry the ``gpu`` marker and skip, through the
``gpu_device`` fixture, where there is none. On a machine with a GPU they
run with ``NBODYAX_TEST_DEVICE=gpu python -m pytest tests/ -m gpu``, which
leaves JAX on its default device instead of pinning the CPU.
"""

import os

ON_GPU = os.environ.get("NBODYAX_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # tests run on the CPU
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The default device, for ``gpu``-marked tests; skips off the GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device: {dev.platform})")
    return dev


@pytest.fixture
def kernel_interpreter(monkeypatch):
    """Runs the Pallas pair kernel in the interpreter wherever it is called,
    for tests that reach it through entry points (the split step, the ring,
    the driver) that take no ``interpret`` argument."""
    from nbodyax.physics import kernels
    raw = kernels.tile_accumulators_raw
    monkeypatch.setattr(kernels, "tile_accumulators_raw",
                        lambda *a, **k: raw(*a, **{**k, "interpret": True}))


# Module-level tier markers (registered in pyproject.toml). Per-test `slow`
# marks live in the test files; these module-wide ones are centralized here so
# the batch recipe in CLAUDE.md has a single source of truth:
#   fast tier:  python -m pytest tests/ -m "not slow"        (<5 min, CI per-push)
#   full suite: sequential batches per CLAUDE.md             (~20 min, CI nightly)
_MODULE_MARKS = {
    "test_barneshut": [pytest.mark.barneshut],
    "test_sharded_bh": [pytest.mark.sharded, pytest.mark.barneshut],
    "test_ring": [pytest.mark.sharded],
    "test_multihost": [pytest.mark.sharded],
    "test_split_step": [pytest.mark.sharded],
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        stem = os.path.splitext(os.path.basename(str(item.fspath)))[0]
        for mark in _MODULE_MARKS.get(stem, ()):
            item.add_marker(mark)
