"""Pallas kernel equivalence vs the jnp oracle (SURVEY.md section 4.3).

Runs in interpreter mode on CPU (the kernel itself is identical; only the
GPU compilation is skipped; tests/test_device_choice.py runs it compiled on
a GPU). Covers all collision modes, N not divisible by the tiles, dead
slots, and offset (ring-hop style) invocation.
"""

import numpy as np
import pytest

from nbodyax.physics.kernels import (body_features, decode_raw,
                                     pallas_pair_accumulators,
                                     tile_accumulators_raw)
from nbodyax.physics.pairwise import pair_accumulators

MODES = ["reference", "momentum", "elastic", "none"]


def random_state(n, seed=0, field=1000.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    if n > 10:
        mass[7] = 0.0  # dead slot
    radius = rng.uniform(5, 40, n).astype(np.float32)  # dense overlaps
    return pos, vel, mass, radius


def assert_equivalent(a, b, mode):
    fa, fb = np.asarray(a.force), np.asarray(b.force)
    scale = max(np.abs(fb).max(), 1e-30)
    assert np.abs(fa - fb).max() / scale < 2e-6
    if mode == "reference":
        np.testing.assert_allclose(np.asarray(a.gained_mass),
                                   np.asarray(b.gained_mass), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(a.gained_radius),
                                   np.asarray(b.gained_radius), rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(a.died), np.asarray(b.died))
    if mode == "momentum":
        np.testing.assert_array_equal(np.asarray(a.parent),
                                      np.asarray(b.parent))
    if mode == "elastic":
        da, db = np.asarray(a.dv), np.asarray(b.dv)
        scale = max(np.abs(db).max(), 1e-30)
        # dv gates at 1e-5, not the force channel's 2e-6: the kernel sums
        # m_j/(m_i+m_j) * vdotp/d2 * dp per pair and doubles once at the
        # end, a different f32 rounding order from the oracle's; 1e-5 stays
        # far tighter than any physical meaning of a velocity impulse while
        # still catching structural bugs
        assert np.abs(da - db).max() / scale < 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 100, 300])
def test_kernel_matches_oracle(mode, n):
    pos, vel, mass, radius = random_state(n, seed=n)
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode,
                                 growth_rate=0.1, tile_i=32, tile_j=128,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, growth_rate=0.1)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("tiles", [(8, 128), (16, 256), (64, 128)])
def test_kernel_tile_invariance(tiles):
    pos, vel, mass, radius = random_state(200, seed=3)
    ti, tj = tiles
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode="reference",
                                 growth_rate=0.1, tile_i=ti, tile_j=tj,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode="reference",
                          growth_rate=0.1)
    assert_equivalent(a, b, "reference")


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_kernel_many_j_tiles(mode):
    """A long sweep (69 j-tiles of 16, the last one padded): per-lane sums
    and the momentum lanes' lowest-id tie-break across tiles."""
    n, tj = 1100, 16
    pos, vel, mass, radius = random_state(n, seed=21, field=3000.0)
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode,
                                 growth_rate=0.1, tile_i=32, tile_j=tj,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, growth_rate=0.1)
    assert_equivalent(a, b, mode)


@pytest.fixture
def short_lanes(monkeypatch):
    """Lanes of at most 4 terms, so small N takes several j spans. The span
    count is fixed when the jitted kernel wrapper traces, hence the cache
    clears around the patch."""
    import jax

    from nbodyax.physics import kernels
    jax.clear_caches()
    monkeypatch.setattr(kernels, "MAX_LANE_TERMS", 4)
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("mode", MODES)
def test_kernel_j_spans_match_oracle(mode, short_lanes):
    """N=300 in 16-wide tiles, at most 4 tiles per span: 5 spans of 64
    columns, the last one padded. Spans are summed (additive channels) or
    max-combined (momentum); masses from three values make equal-mass
    candidates across spans, so the lowest-id tie-break must hold across
    them too."""
    n = 300
    pos, vel, _, radius = random_state(n, seed=17, field=300.0)
    mass = np.random.RandomState(17).choice(
        np.float32([10.0, 20.0, 30.0]), n)
    mass[7] = 0.0
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode,
                                 growth_rate=0.1, tile_i=32, tile_j=16,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, growth_rate=0.1)
    if mode == "momentum":
        assert np.sum(np.asarray(b.parent) != np.arange(n)) > 50
    assert_equivalent(a, b, mode)


def test_kernel_offset_partition_equals_full():
    """Ring-hop building block: i-chunk vs the full j set, computed as two
    offset kernel calls over j halves, combined, equals the full pass."""
    from nbodyax.physics.pairwise import combine_accumulators
    n = 128
    pos, vel, mass, radius = random_state(n, seed=9)
    feats = np.asarray(body_features(pos, vel, mass, radius))
    half = n // 2
    # i rows 32..64 against j halves with correct global offsets
    i0, i1 = 32, 64
    fi = feats[i0:i1]
    rawA, parA = tile_accumulators_raw(fi, feats[:half].T, i0, 0,
                                       mode="momentum", eps=0.0,
                                       growth_rate=0.1, tile_i=8, tile_j=128,
                                       interpret=True)
    rawB, parB = tile_accumulators_raw(fi, feats[half:].T, i0, half,
                                       mode="momentum", eps=0.0,
                                       growth_rate=0.1, tile_i=8, tile_j=128,
                                       interpret=True)
    accA = decode_raw(rawA, parA, i0, mass[i0:i1], "momentum")
    accB = decode_raw(rawB, parB, i0, mass[i0:i1], "momentum")
    combined = combine_accumulators(accA, accB)
    full = pair_accumulators(pos, vel, mass, radius, mode="momentum",
                             growth_rate=0.1)
    np.testing.assert_array_equal(np.asarray(combined.parent),
                                  np.asarray(full.parent)[i0:i1])
    np.testing.assert_allclose(np.asarray(combined.force),
                               np.asarray(full.force)[i0:i1],
                               rtol=1e-5, atol=1e-6)


def test_step_with_pallas_backend_matches_jnp():
    """Full euler step: pallas backend == jnp backend on the same state."""
    from nbodyax.backends import build_accum_fn
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.state import make_state
    from functools import partial

    pos, vel, mass, radius = random_state(150, seed=4)
    st = make_state(pos, vel, mass, radius)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000)
    jnp_step = make_step(p)
    pal_step = make_step(p, accum_fn=partial(
        pallas_pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=p.collision_mode, tile_i=32, tile_j=128, interpret=True))
    a, b = pal_step(st), jnp_step(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.mass) > 0,
                                  np.asarray(b.mass) > 0)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_oracle_softened(mode):
    """eps > 0 takes different static branches in the kernel (e.g. the
    elastic force path elides its singularity mask when softened) — the
    softened variants must match the oracle too."""
    pos, vel, mass, radius = random_state(200, seed=11)
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode, eps=25.0,
                                 growth_rate=0.1, tile_i=32, tile_j=128,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, eps=25.0,
                          growth_rate=0.1)
    assert_equivalent(a, b, mode)


def test_kernel_elastic_coincident_bodies_softened_no_nan():
    """Exactly coincident bodies with softening on: the elided mask path must
    still produce zero impulse and finite force (vdotp==0 gates it)."""
    pos = np.zeros((8, 2), np.float32)
    vel = np.tile(np.array([[1.0, -0.5]], np.float32), (8, 1))
    mass = np.full(8, 5.0, np.float32)
    radius = np.full(8, 2.0, np.float32)
    acc = pallas_pair_accumulators(pos, vel, mass, radius, mode="elastic",
                                   eps=10.0, growth_rate=0.1,
                                   tile_i=8, tile_j=128, interpret=True)
    assert np.isfinite(np.asarray(acc.force)).all()
    np.testing.assert_array_equal(np.asarray(acc.dv), 0.0)
