"""3-D simulation mode (framework extension; the reference is 2-D only).

``dimensions=3`` generalizes the whole exact-force stack — oracle, Pallas
kernel, integrators, boundary, collision modes, ring sharding, driver — to
[N, 3] state. The strongest check here is *planar equivalence*: a 3-D run
whose bodies all sit at z=0 must reproduce the 2-D run's xy trajectories
bit-for-bit (every added z term is exactly 0.0 in f32, so no rounding can
diverge). On top of that: analytic 2-body forces off-plane, conservation laws
per collision mode, z-boundary reflection, and the sharded ring on the
virtual mesh.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

from nbodyax.config import ConfigError, SimConfig, parse_config_text
from nbodyax.physics.kernels import pallas_pair_accumulators
from nbodyax.physics.pairwise import pair_accumulators
from nbodyax.physics.step import GRAV_CONSTANT, PhysicsParams, make_step
from nbodyax.state import make_state

MODES = ["reference", "momentum", "elastic", "none"]


def random_state_3d(n, seed=0, field=1000.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    if n > 10:
        mass[7] = 0.0  # dead slot
    radius = rng.uniform(5, 60, n).astype(np.float32)  # dense overlaps
    return pos, vel, mass, radius


def test_oracle_3d_two_body_analytic():
    """Force between two bodies along an arbitrary 3-D separation equals
    m_j * d_vec / |d|^3 (reference kernel semantics, nbody.cu:230-239)."""
    d = np.array([3.0, -4.0, 12.0], np.float32)           # |d| = 13
    pos = np.stack([np.zeros(3, np.float32), d])
    vel = np.zeros((2, 3), np.float32)
    mass = np.array([5.0, 80.0], np.float32)
    radius = np.array([1.0, 1.0], np.float32)
    acc = pair_accumulators(pos, vel, mass, radius, mode="none")
    f = np.asarray(acc.force)
    expect0 = mass[1] * d / 13.0 ** 3
    np.testing.assert_allclose(f[0], expect0, rtol=1e-6)
    np.testing.assert_allclose(f[1], -mass[0] * d / 13.0 ** 3, rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_oracle_3d(mode):
    pos, vel, mass, radius = random_state_3d(200, seed=17)
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode,
                                 growth_rate=0.1, tile_i=32, tile_j=128,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, growth_rate=0.1)
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
        assert np.abs(da - db).max() / scale < 2e-6


@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_kernel_matches_oracle_3d_softened(mode):
    pos, vel, mass, radius = random_state_3d(150, seed=23)
    a = pallas_pair_accumulators(pos, vel, mass, radius, mode=mode, eps=25.0,
                                 growth_rate=0.1, tile_i=32, tile_j=128,
                                 interpret=True)
    b = pair_accumulators(pos, vel, mass, radius, mode=mode, eps=25.0,
                          growth_rate=0.1)
    fa, fb = np.asarray(a.force), np.asarray(b.force)
    assert np.abs(fa - fb).max() / max(np.abs(fb).max(), 1e-30) < 2e-6


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("mode", MODES)
def test_planar_3d_run_matches_2d_exactly(mode, integrator):
    """z=0 everywhere: the 3-D step's xy output must be BIT-exact vs 2-D
    (all added z terms are 0.0; f32 addition of 0.0 is exact) and z must
    stay 0."""
    rng = np.random.RandomState(5)
    n = 96
    pos2 = rng.uniform(-800, 800, (n, 2)).astype(np.float32)
    vel2 = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(5, 50, n).astype(np.float32)
    z = np.zeros((n, 1), np.float32)
    pos3 = np.concatenate([pos2, z], axis=1)
    vel3 = np.concatenate([vel2, z], axis=1)

    p = PhysicsParams(dt=0.2, field_width=1000, field_height=1000,
                      field_depth=1000, collision_mode=mode,
                      integrator=integrator)
    step = make_step(p)
    s2 = make_state(pos2, vel2, mass, radius)
    s3 = make_state(pos3, vel3, mass, radius)
    for _ in range(5):
        s2, s3 = step(s2), step(s3)
    np.testing.assert_array_equal(np.asarray(s3.pos)[:, :2], np.asarray(s2.pos))
    np.testing.assert_array_equal(np.asarray(s3.vel)[:, :2], np.asarray(s2.vel))
    np.testing.assert_array_equal(np.asarray(s3.mass), np.asarray(s2.mass))
    np.testing.assert_array_equal(np.asarray(s3.pos)[:, 2], 0.0)


def test_boundary_flip_z():
    """A body heading out of the +z face reflects vz (reference Q6 probe
    generalized to the third axis)."""
    pos = np.array([[0.0, 0.0, 990.0], [500.0, 0.0, 0.0]], np.float32)
    vel = np.array([[0.0, 0.0, 100.0], [0.0, 0.0, 0.0]], np.float32)
    mass = np.array([10.0, 10.0], np.float32)
    radius = np.array([50.0, 1.0], np.float32)
    p = PhysicsParams(dt=0.2, field_width=1000, field_height=1000,
                      field_depth=1000, collision_mode="none",
                      boundary_mode="clamp")
    s = make_step(p)(make_state(pos, vel, mass, radius))
    out = np.asarray(s.vel)
    assert out[0, 2] < 0  # reflected
    assert np.asarray(s.pos)[0, 2] <= 1000.0 - 50.0


def test_momentum_merge_3d_conserves():
    """Momentum-conserving merges conserve mass and all three momentum
    components through a step with many overlaps."""
    pos, vel, mass, radius = random_state_3d(128, seed=31, field=200.0)
    mass[7] = 50.0  # no dead slots: exact bookkeeping
    st = make_state(pos, vel, mass, radius)
    p = PhysicsParams(dt=0.0, field_width=1e9, field_height=1e9,
                      field_depth=1e9, collision_mode="momentum",
                      boundary_mode="none")
    out = make_step(p)(st)
    m0, m1 = np.asarray(st.mass), np.asarray(out.mass)
    assert (m1 > 0).sum() < 128  # merges actually happened
    np.testing.assert_allclose(m1.sum(), m0.sum(), rtol=1e-6)
    p0 = (m0[:, None] * np.asarray(st.vel)).sum(0)
    p1 = (m1[:, None] * np.asarray(out.vel)).sum(0)
    np.testing.assert_allclose(p1, p0, rtol=1e-4, atol=1e-3)


def test_elastic_3d_two_body_conserves_energy_momentum():
    """Head-on 3-D elastic contact: total momentum exact, KE conserved."""
    pos = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 12.0]], np.float32)
    d = pos[1] / 13.0
    vel = np.stack([5.0 * d, -2.0 * d]).astype(np.float32)  # approaching
    mass = np.array([2.0, 6.0], np.float32)
    radius = np.array([7.0, 7.0], np.float32)  # overlapping
    st = make_state(pos, vel, mass, radius)
    p = PhysicsParams(dt=0.0, field_width=1e9, field_height=1e9,
                      field_depth=1e9, collision_mode="elastic",
                      boundary_mode="none")
    out = make_step(p)(st)
    v0, v1 = np.asarray(st.vel), np.asarray(out.vel)
    np.testing.assert_allclose((mass[:, None] * v1).sum(0),
                               (mass[:, None] * v0).sum(0),
                               rtol=1e-5, atol=1e-5)
    ke0 = 0.5 * (mass * (v0 * v0).sum(1)).sum()
    ke1 = 0.5 * (mass * (v1 * v1).sum(1)).sum()
    np.testing.assert_allclose(ke1, ke0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_ring_3d_matches_dense(mode):
    """Sharded ring step over the 8-device virtual mesh == single-device
    step, in 3-D."""
    from nbodyax.sharding.mesh import make_mesh, shard_state
    from nbodyax.sharding.ring import make_sharded_step

    n = 128
    pos, vel, mass, radius = random_state_3d(n, seed=41, field=500.0)
    cfg = SimConfig(particle_count=n, shards=8, backend="jnp",
                    dimensions=3, field_width=1000, field_height=1000,
                    collision_mode=mode)
    p = PhysicsParams.from_config(cfg)
    st = make_state(pos, vel, mass, radius)
    dense = make_step(p)(st)
    mesh = make_mesh(8)
    sharded = make_sharded_step(cfg, p, mesh=mesh)(shard_state(st, mesh))
    np.testing.assert_allclose(np.asarray(sharded.pos), np.asarray(dense.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(sharded.mass) > 0,
                                  np.asarray(dense.mass) > 0)


def test_split_step_3d_matches_monolithic(kernel_interpreter):
    from nbodyax.physics.step import make_split_step
    pos, vel, mass, radius = random_state_3d(100, seed=47, field=500.0)
    p = PhysicsParams(dt=0.2, field_width=1000, field_height=1000,
                      field_depth=1000, collision_mode="momentum")
    st = make_state(pos, vel, mass, radius)
    split = make_split_step(p, n_splits=4, tile_i=32, tile_j=128, dim=3)
    accum = partial(pallas_pair_accumulators, eps=0.0, growth_rate=0.1,
                    mode="momentum", tile_i=32, tile_j=128, interpret=True)
    mono = make_step(p, accum_fn=accum)
    a, b = split(st), mono(st)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.mass), np.asarray(b.mass))


def test_config_3d_validation():
    cfg = parse_config_text("dimensions=3\nfieldDepth=50000\n")
    assert cfg.dimensions == 3 and cfg.field_depth == 50000
    p = PhysicsParams.from_config(cfg)
    assert p.field_depth == 50000.0
    # fieldDepth=0 falls back to fieldWidth
    p2 = PhysicsParams.from_config(parse_config_text("dimensions=3\n"))
    assert p2.field_depth == p2.field_width
    with pytest.raises(ConfigError):
        SimConfig(dimensions=4).validate()
    # 3-D octree caps the finest level at 7 (2^(3*7) = 2M cells)
    with pytest.raises(ConfigError):
        SimConfig(dimensions=3, force_model="bh", bh_levels=9).validate()
    SimConfig(dimensions=3, force_model="bh", bh_levels=6).validate()


def test_scenes_3d_shapes():
    from nbodyax.scenes import init_scene
    cfg = SimConfig(particle_count=64, dimensions=3, field_width=1000,
                    field_height=1000, field_depth=400)
    st = init_scene(cfg)
    assert st.pos.shape == (64, 3) and st.vel.shape == (64, 3)
    assert abs(np.asarray(st.pos)[:, 2]).max() <= 400.0
    g = init_scene(dataclasses.replace(cfg, scene="galaxy"))
    assert g.pos.shape == (64, 3)
    t = init_scene(dataclasses.replace(cfg, particle_count=3,
                                       scene="three_body"))
    assert t.pos.shape == (3, 3)
    np.testing.assert_array_equal(np.asarray(t.pos)[:, 2], 0.0)


def rel_force_err(a, b):
    fa, fb = np.asarray(a.force, np.float64), np.asarray(b.force, np.float64)
    scale = np.linalg.norm(fb, axis=1)
    denom = np.maximum(scale, np.percentile(scale, 50))
    return (np.linalg.norm(fa - fb, axis=1) / denom).max()


@pytest.mark.parametrize("ring,order,tol", [(1, 1, 0.08), (1, 2, 0.02),
                                            (2, 2, 0.01)])
@pytest.mark.slow
def test_bh_3d_far_field_accuracy(ring, order, tol):
    """Octree far field vs the exact oracle in 3-D (monopole and
    quadrupole)."""
    from nbodyax.physics.barneshut import bh_accumulators
    rng = np.random.RandomState(11)
    n = 2048
    pos = rng.uniform(-5000, 5000, (n, 3)).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(1, 8, n).astype(np.float32)
    bh = bh_accumulators(pos, vel, mass, radius, eps=50.0, mode="none",
                         ring=ring, levels=3, neighbor_k=256, order=order)
    ex = pair_accumulators(pos, vel, mass, radius, eps=50.0, mode="none")
    assert rel_force_err(bh, ex) < tol


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_bh_3d_collision_channels_match_exact(mode):
    """3-D near field: with the whole neighborhood inside the window the
    collision decisions are exact, as in 2-D."""
    from nbodyax.physics.barneshut import bh_accumulators
    rng = np.random.RandomState(13)
    n = 1024
    pos = rng.uniform(-2000, 2000, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(20, 60, n).astype(np.float32)  # dense overlaps
    # cell size 2*2000*1.0001/8 = 500 > 2*rmax: all overlaps in-window
    bh = bh_accumulators(pos, vel, mass, radius, eps=10.0, growth_rate=0.1,
                         mode=mode, levels=3, neighbor_k=256)
    ex = pair_accumulators(pos, vel, mass, radius, eps=10.0, growth_rate=0.1,
                           mode=mode)
    if mode == "reference":
        np.testing.assert_allclose(np.asarray(bh.gained_mass),
                                   np.asarray(ex.gained_mass), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(bh.died), np.asarray(ex.died))
    if mode == "momentum":
        np.testing.assert_array_equal(np.asarray(bh.parent),
                                      np.asarray(ex.parent))
    if mode == "elastic":
        da, de = np.asarray(bh.dv), np.asarray(ex.dv)
        assert np.abs(da - de).max() / max(np.abs(de).max(), 1e-30) < 2e-5


@pytest.mark.slow
def test_bh_3d_step_trajectory_close_to_exact():
    from functools import partial as _partial
    from nbodyax.physics.barneshut import bh_accumulators
    rng = np.random.RandomState(17)
    n = 512
    pos = rng.uniform(-2000, 2000, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(1, 8, n).astype(np.float32)
    st = make_state(pos, vel, mass, radius)
    p = PhysicsParams(dt=0.2, field_width=2000, field_height=2000,
                      field_depth=2000, eps=50.0)
    exact = make_step(p)
    bh = make_step(p, accum_fn=_partial(
        bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=p.collision_mode, ring=2, levels=3, neighbor_k=256))
    a = b = st
    for _ in range(10):
        a, b = bh(a), exact(b)
    np.testing.assert_array_equal(np.asarray(a.mass) > 0,
                                  np.asarray(b.mass) > 0)
    assert np.abs(np.asarray(a.pos) - np.asarray(b.pos)).max() / 4000.0 < 0.01


@pytest.mark.slow
def test_bh_3d_sharded_matches_single():
    from nbodyax.sharding.bh import make_sharded_bh_step
    from nbodyax.sharding.mesh import make_mesh, shard_state
    from nbodyax.backends import build_accum_fn

    n = 256
    rng = np.random.RandomState(19)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(1, 10, n).astype(np.float32)
    st = make_state(pos, vel, mass, radius)
    cfg = SimConfig(particle_count=n, shards=8, dimensions=3,
                    field_width=1000, field_height=1000, force_model="bh",
                    softening=20.0, bh_levels=3, bh_neighbor_k=128)
    p = PhysicsParams.from_config(cfg)
    dense = make_step(p, accum_fn=build_accum_fn("jnp", p, cfg))(st)
    mesh = make_mesh(8)
    sh = make_sharded_bh_step(cfg, p, mesh=mesh)(shard_state(st, mesh))
    np.testing.assert_allclose(np.asarray(sh.pos), np.asarray(dense.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(sh.mass) > 0,
                                  np.asarray(dense.mass) > 0)


def test_driver_3d_end_to_end(tmp_path):
    """Full driver run in 3-D: frames (xy projection), checkpoint, metrics,
    tools dump."""
    from nbodyax.driver import run_simulation
    from nbodyax.io.checkpoint import latest_checkpoint
    from nbodyax.tools import dump_checkpoint

    cfg = SimConfig(particle_count=64, total_iterations=4, dimensions=3,
                    field_width=1000, field_height=1000,
                    save_image_every=2, image_path=str(tmp_path / "img"),
                    checkpoint_every=4, checkpoint_path=str(tmp_path / "ck"),
                    log_every=2, log_path=str(tmp_path / "log.jsonl"),
                    seed=7).validate()
    res = run_simulation(cfg, quiet=True)
    assert res.frames_written == 2
    assert np.isfinite(np.asarray(res.state.pos)).all()
    assert res.state.pos.shape == (64, 3)
    ck = latest_checkpoint(cfg.checkpoint_path)
    assert ck is not None
    import io
    buf = io.StringIO()
    dump_checkpoint(ck, limit=2, out=buf)
    assert buf.getvalue().count(",") >= 4  # 3-component position rows
    import json
    rec = json.loads(open(cfg.log_path).readline())
    assert "momentum_z" in rec
