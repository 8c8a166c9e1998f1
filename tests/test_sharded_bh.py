"""Sharded bh step on 8 virtual devices == single-device bh step."""

import numpy as np
import pytest

from nbodyax.config import SimConfig
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.physics.barneshut import bh_accumulators
from nbodyax.sharding.bh import make_sharded_bh_step
from nbodyax.sharding.mesh import make_mesh, pad_to_shards, shard_state
from nbodyax.state import make_state
from functools import partial

# full-module slow tier: every case here compiles multi-engine
# bh/shard graphs (CLAUDE.md batch recipe); the fast tier keeps bh
# coverage via tests/test_giants.py smoke
pytestmark = pytest.mark.slow

N_DEV = 8


def random_state(n, seed=0, field=2000.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(1, 15, n).astype(np.float32)
    return make_state(pos, vel, mass, radius)


@pytest.mark.parametrize("near", ["rows", "slots"])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_sharded_bh_matches_single_device(mode, near):
    n = 512
    st = random_state(n, seed=1)
    p = PhysicsParams(dt=0.1, field_width=2000, field_height=2000,
                      eps=10.0, collision_mode=mode)
    cfg = SimConfig(shards=N_DEV, force_model="bh", collision_mode=mode,
                    bh_levels=4, bh_neighbor_k=128, softening=10.0,
                    bh_near=near)
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_bh_step(cfg, p, mesh=mesh)
    single = make_step(p, accum_fn=partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=mode, levels=4, neighbor_k=128, near=near))
    a = sharded(shard_state(pad_to_shards(st, N_DEV), mesh))
    b = single(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.mass), np.asarray(b.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-3)


def test_sharded_bh_multi_step():
    n = 256
    st = random_state(n, seed=5)
    p = PhysicsParams(dt=0.05, field_width=2000, field_height=2000, eps=20.0)
    cfg = SimConfig(shards=N_DEV, force_model="bh", bh_levels=3,
                    bh_neighbor_k=128, softening=20.0)
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_bh_step(cfg, p, mesh=mesh)
    single = make_step(p, accum_fn=partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode="reference", levels=3, neighbor_k=128))
    a = shard_state(pad_to_shards(st, N_DEV), mesh)
    b = st
    for _ in range(5):
        a = sharded(a)
        b = single(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-4, atol=1e-2)
    assert int(np.asarray(a.step)) == 5


def test_driver_routes_sharded_bh():
    from nbodyax.driver import build_step
    cfg = SimConfig(shards=N_DEV, force_model="bh", particle_count=64,
                    backend="jnp", softening=10.0)
    step = build_step(cfg)  # must not raise
    st = shard_state(pad_to_shards(random_state(64, seed=2), N_DEV),
                     make_mesh(N_DEV))
    out = step(st)
    assert np.isfinite(np.asarray(out.pos)).all()


def test_sharded_bh_leapfrog_matches_single_device():
    n = 256
    st = random_state(n, seed=7)
    p = PhysicsParams(dt=0.05, field_width=2000, field_height=2000, eps=20.0,
                      integrator="leapfrog")
    cfg = SimConfig(shards=N_DEV, force_model="bh", bh_levels=3,
                    bh_neighbor_k=128, softening=20.0, integrator="leapfrog")
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_bh_step(cfg, p, mesh=mesh)
    single = make_step(p, accum_fn=partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode="reference", levels=3, neighbor_k=128))
    a = shard_state(pad_to_shards(st, N_DEV), mesh)
    b = st
    for _ in range(3):
        a = sharded(a)
        b = single(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-4, atol=1e-2)


def test_sharded_bh_scale_representative():
    """Denser, more representative scale on the virtual mesh (N=8192,
    levels=5): the compute-parallel design must stay exact-equal to the
    single-device bh step (memory/interconnect accounting in
    sharding/bh.py)."""
    n = 8192
    st = random_state(n, seed=11, field=20000.0)
    p = PhysicsParams(dt=0.1, field_width=20000, field_height=20000, eps=20.0)
    cfg = SimConfig(shards=N_DEV, force_model="bh", bh_levels=5,
                    bh_neighbor_k=64, softening=20.0)
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_bh_step(cfg, p, mesh=mesh)
    single = make_step(p, accum_fn=partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode="reference", levels=5, neighbor_k=64))
    a = sharded(shard_state(pad_to_shards(st, N_DEV), mesh))
    b = single(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(a.mass) > 0,
                                  np.asarray(b.mass) > 0)


@pytest.mark.parametrize("near", ["rows", "slots"])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_cellrange_shards_are_disjoint_and_complete(mode, near):
    """bh_cellrange_accumulators over all shard indices must partition the
    full bh_accumulators result: each body's row is non-identity on exactly
    one shard (the owner of its finest cell), and the identity-rebased sum
    over shards reproduces the single evaluation — the invariant the
    sharded step's psum_scatter merge rests on. A 200-body cluster in one
    cell (>> _CI_CAP) forces the sliced completion path too."""
    import jax.numpy as jnp
    from nbodyax.physics.barneshut import bh_cellrange_accumulators
    from nbodyax.physics.pairwise import empty_accumulators

    n, nsh = 1024, 4
    rng = np.random.RandomState(7)
    pos = rng.uniform(-2000, 2000, (n, 2)).astype(np.float32)
    pos[:200] = rng.uniform(-40, 40, (200, 2))    # one crowded cell
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(1, 15, n).astype(np.float32)
    kw = dict(eps=10.0, growth_rate=0.1, mode=mode, levels=4,
              neighbor_k=256, near=near)

    full = bh_accumulators(pos, vel, mass, radius, **kw)
    parts = [bh_cellrange_accumulators(pos, vel, mass, radius,
                                       jnp.int32(s), nsh, **kw)
             for s in range(nsh)]
    idx = jnp.arange(n, dtype=jnp.int32)
    ident = empty_accumulators(idx)

    own = np.zeros(n, int)
    for p in parts:
        touched = (np.asarray(p.parent != idx) | np.asarray(p.died)
                   | (np.abs(np.asarray(p.force)).sum(1) > 0)
                   | (np.asarray(p.gained_mass) > 0)
                   | (np.abs(np.asarray(p.dv)).sum(1) > 0))
        own += touched
    assert own.max() <= 1  # disjoint

    merged = ident._replace(
        force=sum(np.asarray(p.force) for p in parts),
        gained_mass=sum(np.asarray(p.gained_mass) for p in parts),
        gained_radius=sum(np.asarray(p.gained_radius) for p in parts),
        died=sum(np.asarray(p.died).astype(int) for p in parts) > 0,
        parent=sum(np.asarray(p.parent - idx) for p in parts) + np.asarray(idx),
        dv=sum(np.asarray(p.dv) for p in parts))
    np.testing.assert_allclose(merged.force, np.asarray(full.force),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(merged.gained_mass,
                               np.asarray(full.gained_mass), rtol=1e-6)
    np.testing.assert_array_equal(merged.died, np.asarray(full.died))
    np.testing.assert_array_equal(merged.parent, np.asarray(full.parent))
    # dv is the one lane whose completion-pass summation order depends on
    # the chunk length (256-row slices vs one 1024-row pass) — float-level
    # reassociation only, hence the looser tolerance
    np.testing.assert_allclose(merged.dv, np.asarray(full.dv),
                               rtol=1e-5, atol=1e-5)


def test_sharded_bh_yoshida_matches_single_device():
    """yoshida4's three extra force passes ride bh_acc (gather + cell-range
    eval + psum_scatter) — the 4th-order sharded step must match the
    single-device bh step."""
    n = 256
    st = random_state(n, seed=9)
    p = PhysicsParams(dt=0.05, field_width=2000, field_height=2000, eps=20.0,
                      collision_mode="none", integrator="yoshida4")
    cfg = SimConfig(shards=N_DEV, force_model="bh", bh_levels=3,
                    bh_neighbor_k=128, softening=20.0, collision_mode="none",
                    integrator="yoshida4")
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_bh_step(cfg, p, mesh=mesh)
    single = make_step(p, accum_fn=partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode="none", levels=3, neighbor_k=128))
    a = shard_state(pad_to_shards(st, N_DEV), mesh)
    b = st
    for _ in range(2):
        a = sharded(a)
        b = single(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-4, atol=1e-2)
