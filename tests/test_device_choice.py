"""Device-dependent choices, checked on the CPU: which all-pairs engine
``backend=auto`` picks, that the GPU kernel never falls back to the Pallas
interpreter on its own, where the compile cache goes, and that
chip_smoke.py refuses to report success without a GPU. The ``gpu``-marked
test runs the compiled kernel on a card and skips here."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from nbodyax import backends, cache
from nbodyax.physics import kernels
from nbodyax.physics.pairwise import pair_accumulators

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_bodies(n=96, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-500, 500, (n, 2)).astype(np.float32),
            rng.uniform(-3, 3, (n, 2)).astype(np.float32),
            rng.uniform(1, 100, n).astype(np.float32),
            rng.uniform(5, 40, n).astype(np.float32))


@pytest.mark.parametrize("platform, expected",
                         [("cpu", "jnp"), ("gpu", "pallas")])
def test_auto_backend_follows_default_platform(monkeypatch, platform,
                                               expected):
    monkeypatch.setattr(backends.jax, "default_backend", lambda: platform)
    assert backends.resolve_backend("auto") == expected
    # explicit names are never rewritten
    assert backends.resolve_backend("jnp") == "jnp"
    assert backends.resolve_backend("pallas") == "pallas"


def test_auto_backend_is_jnp_on_this_cpu():
    assert jax.default_backend() == "cpu"
    assert backends.resolve_backend("auto") == "jnp"


@pytest.mark.parametrize("entry", ["pallas_pair_accumulators",
                                   "tile_accumulators_raw"])
def test_kernel_raises_off_gpu_without_interpret(entry):
    pos, vel, mass, radius = small_bodies()
    if entry == "pallas_pair_accumulators":
        call = lambda: kernels.pallas_pair_accumulators(pos, vel, mass,
                                                        radius)
    else:
        f = kernels.body_features(pos, vel, mass, radius)
        call = lambda: kernels.tile_accumulators_raw(
            f, f.T, 0, 0, mode="reference", eps=0.0, growth_rate=0.1)
    with pytest.raises(RuntimeError, match="interpret=True"):
        call()


def test_kernel_rejects_tiles_that_are_not_powers_of_two():
    pos, vel, mass, radius = small_bodies()
    with pytest.raises(ValueError, match="powers of two"):
        kernels.pallas_pair_accumulators(pos, vel, mass, radius, tile_i=48,
                                         interpret=True)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache") == cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split(), "cache must be ignored"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU (this CPU run) or no nbodyax beside it: exit non-zero and
    never print the success line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic", "none"])
def test_compiled_kernel_matches_oracle(gpu_device, mode):
    # N is not a multiple of the tiles: the padded tail is exercised too
    pos, vel, mass, radius = small_bodies(n=4000, seed=3)
    a = kernels.pallas_pair_accumulators(pos, vel, mass, radius, mode=mode)
    with jax.default_matmul_precision("highest"):
        b = pair_accumulators(pos, vel, mass, radius, mode=mode)
    fa, fb = np.asarray(a.force), np.asarray(b.force)
    assert np.abs(fa - fb).max() / np.abs(fb).max() < 1e-5
    if mode == "reference":
        np.testing.assert_array_equal(np.asarray(a.died), np.asarray(b.died))
    if mode == "momentum":
        np.testing.assert_array_equal(np.asarray(a.parent),
                                      np.asarray(b.parent))
