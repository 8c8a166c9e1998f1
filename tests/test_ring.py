"""Distributed-without-a-cluster tests (SURVEY.md section 4.4): the ppermute
ring over 8 fake CPU devices must reproduce the single-device step."""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nbodyax.config import SimConfig
from nbodyax.physics.pairwise import pair_accumulators
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.sharding.mesh import AXIS, make_mesh, pad_to_shards, shard_state
from nbodyax.sharding.ring import (make_local_accum_fn, make_sharded_step,
                                   ring_accumulators)
from nbodyax.state import make_state

N_DEV = 8


def random_state(n, seed=0, field=1000.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    return make_state(pos, vel, mass, radius)


def test_mesh_has_8_fake_devices():
    assert len(jax.devices()) == N_DEV
    mesh = make_mesh(N_DEV)
    assert mesh.devices.size == N_DEV


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_ring_accumulators_match_dense(mode, backend, kernel_interpreter):
    """backend="pallas" runs the Pallas kernel in interpret mode inside the
    ring — the code path four GPUs execute (ring hop -> kernel tile pass
    with nonzero j offsets), minus only the GPU compilation."""
    n = 256  # 32 bodies per shard
    st = random_state(n, seed=1)
    p = PhysicsParams(collision_mode=mode)
    mesh = make_mesh(N_DEV)
    accum_fn = make_local_accum_fn(backend, p)

    ringed = jax.jit(jax.shard_map(
        lambda pos, vel, m, r: ring_accumulators(
            pos, vel, m, r, n_shards=N_DEV, accum_fn=accum_fn),
        mesh=mesh, in_specs=(P(AXIS),) * 4, out_specs=P(AXIS),
        check_vma=False))

    acc_r = ringed(st.pos, st.vel, st.mass, st.radius)
    acc_d = pair_accumulators(st.pos, st.vel, st.mass, st.radius,
                              mode=mode, growth_rate=0.1)
    fr, fd = np.asarray(acc_r.force), np.asarray(acc_d.force)
    scale = max(np.abs(fd).max(), 1e-30)
    assert np.abs(fr - fd).max() / scale < 2e-6
    if mode == "reference":
        np.testing.assert_allclose(np.asarray(acc_r.gained_mass),
                                   np.asarray(acc_d.gained_mass), rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(acc_r.died),
                                      np.asarray(acc_d.died))
    if mode == "momentum":
        np.testing.assert_array_equal(np.asarray(acc_r.parent),
                                      np.asarray(acc_d.parent))
    if mode == "elastic":
        np.testing.assert_allclose(np.asarray(acc_r.dv), np.asarray(acc_d.dv),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_sharded_step_matches_single_device(mode, backend,
                                            kernel_interpreter):
    n = 256
    st = random_state(n, seed=2)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000,
                      collision_mode=mode)
    cfg = SimConfig(shards=N_DEV, backend=backend, collision_mode=mode)
    mesh = make_mesh(N_DEV)
    st_sh = shard_state(pad_to_shards(st, N_DEV), mesh)

    sharded = make_sharded_step(cfg, p, mesh=mesh)
    single = make_step(p)

    a = sharded(st_sh)
    b = single(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.mass), np.asarray(b.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.radius), np.asarray(b.radius),
                               rtol=1e-6)


def test_sharded_multi_step_trajectory():
    """5 steps sharded vs single-device — divergence stays at f32 rounding."""
    n = 128
    st = random_state(n, seed=5)
    p = PhysicsParams(dt=0.05, field_width=1000, field_height=1000)
    cfg = SimConfig(shards=N_DEV, backend="jnp")
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_step(cfg, p, mesh=mesh)
    single = make_step(p)
    a = shard_state(pad_to_shards(st, N_DEV), mesh)
    b = st
    for _ in range(5):
        a = sharded(a)
        b = single(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-4, atol=1e-3)
    assert int(np.asarray(a.step)) == 5


def test_padded_capacity_not_multiple_of_shards():
    n = 100  # pads to 104
    st = random_state(n, seed=7)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000)
    cfg = SimConfig(shards=N_DEV, backend="jnp")
    mesh = make_mesh(N_DEV)
    padded = pad_to_shards(st, N_DEV)
    assert padded.capacity == 104
    sharded = make_sharded_step(cfg, p, mesh=mesh)
    out = sharded(shard_state(padded, mesh))
    ref = make_step(p)(st)
    np.testing.assert_allclose(np.asarray(out.pos)[:n], np.asarray(ref.pos),
                               rtol=1e-5, atol=1e-4)
    assert np.all(np.asarray(out.mass)[n:] == 0)  # padding stays dead


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_sharded_leapfrog_matches_single_device(mode):
    """integrator=leapfrog x shards>1: the ring runs KDK's two force passes."""
    n = 256
    st = random_state(n, seed=3)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000,
                      collision_mode=mode, integrator="leapfrog")
    cfg = SimConfig(shards=N_DEV, backend="jnp", collision_mode=mode,
                    integrator="leapfrog")
    mesh = make_mesh(N_DEV)
    sharded = make_sharded_step(cfg, p, mesh=mesh)
    single = make_step(p)
    a = shard_state(pad_to_shards(st, N_DEV), mesh)
    b = st
    for _ in range(3):
        a = sharded(a)
        b = single(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.mass), np.asarray(b.mass),
                               rtol=1e-6)


def test_sharded_elastic_restitution_matches_single_device():
    """restitution rides resolve_collisions_sharded's shared commit point —
    pin the sharded elastic e=0.5 step to the single-device step."""
    n = 256
    st = random_state(n, seed=5)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000,
                      collision_mode="elastic", restitution=0.5)
    cfg = SimConfig(shards=N_DEV, backend="jnp", collision_mode="elastic",
                    restitution=0.5)
    mesh = make_mesh(N_DEV)
    st_sh = shard_state(pad_to_shards(st, N_DEV), mesh)
    a = make_sharded_step(cfg, p, mesh=mesh)(st_sh)
    b = make_step(p)(st)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-4)


def test_sharded_yoshida_matches_single_device():
    """yoshida4's extra force passes ride the same ring accumulators —
    sharded == single-device for the 4th-order step too."""
    n = 256
    st = random_state(n, seed=7)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000,
                      collision_mode="none", integrator="yoshida4")
    cfg = SimConfig(shards=N_DEV, backend="jnp", collision_mode="none",
                    integrator="yoshida4")
    mesh = make_mesh(N_DEV)
    st_sh = shard_state(pad_to_shards(st, N_DEV), mesh)
    a = make_sharded_step(cfg, p, mesh=mesh)(st_sh)
    b = make_step(p)(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-4)
