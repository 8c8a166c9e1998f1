"""Capacity recompaction: the fixed-shape analog of the reference's host
compaction (nbody.cu:488-510)."""

import numpy as np
import pytest

from nbodyax.config import SimConfig
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.state import compact_state, make_state, alive_count


def sparse_state(capacity=1024, alive=100, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1000, 1000, (capacity, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (capacity, 2)).astype(np.float32)
    mass = np.zeros(capacity, np.float32)
    live = rng.choice(capacity, alive, replace=False)
    mass[live] = rng.uniform(1, 10, alive).astype(np.float32)
    radius = rng.uniform(1, 3, capacity).astype(np.float32)
    return make_state(pos, vel, mass, radius)


def test_compact_preserves_live_bodies():
    st = sparse_state()
    out = compact_state(st)
    assert out.capacity == 256  # next pow2 >= 100 * 1.25
    assert alive_count(out) == alive_count(st) == 100
    # survivors keep their exact values, order preserved
    m_in = np.asarray(st.mass)
    live = m_in > 0
    np.testing.assert_array_equal(np.asarray(out.mass)[:100], m_in[live])
    np.testing.assert_array_equal(np.asarray(out.pos)[:100],
                                  np.asarray(st.pos)[live])


def test_compact_noop_when_dense():
    st = sparse_state(capacity=256, alive=250)
    assert compact_state(st) is st


def test_compacted_trajectory_matches():
    """Physics of live bodies is unchanged by dropping dead slots (dead slots
    contribute exact zeros to every sum)."""
    st = sparse_state(capacity=512, alive=64, seed=3)
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000)
    step = make_step(p)
    a = compact_state(st)
    b = st
    for _ in range(5):
        a = step(a)
        b = step(b)
    live_b = np.asarray(b.mass) > 0
    live_a = np.asarray(a.mass) > 0
    np.testing.assert_allclose(np.asarray(a.pos)[live_a],
                               np.asarray(b.pos)[live_b],
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.mass)[live_a],
                               np.asarray(b.mass)[live_b], rtol=1e-6)


def test_driver_compacts(tmp_path):
    """End-to-end: a merging run with compactEvery shrinks capacity."""
    from nbodyax.driver import run_simulation
    cfg = SimConfig(particle_count=512, total_iterations=30,
                    field_width=2000, field_height=2000,
                    save_images=False, log_every=0, compact_every=10,
                    backend="jnp")
    res = run_simulation(cfg, quiet=True)
    # dense overlapping scene merges aggressively; capacity must have shrunk
    assert res.state.capacity < 512
    assert alive_count(res.state) <= res.state.capacity


@pytest.mark.slow
def test_driver_compacts_sharded():
    """Sharded compaction (gather -> compact -> re-pad -> re-shard): a
    merging 8-shard run shrinks capacity mid-run and its surviving bodies
    match the single-device compacted run's exactly (same scene, same
    physics; f32 reduction-order noise only)."""
    from nbodyax.driver import run_simulation
    kw = dict(particle_count=512, total_iterations=30,
              field_width=2000, field_height=2000,
              save_images=False, log_every=0, compact_every=10,
              backend="jnp")
    res1 = run_simulation(SimConfig(**kw), quiet=True)
    res8 = run_simulation(SimConfig(shards=8, **kw), quiet=True)
    assert res8.state.capacity < 512
    m1, m8 = np.asarray(res1.state.mass), np.asarray(res8.state.mass)
    live1, live8 = m1 > 0, m8 > 0
    assert live1.sum() == live8.sum()
    np.testing.assert_allclose(m8[live8], m1[live1], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res8.state.pos)[live8],
                               np.asarray(res1.state.pos)[live1],
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np.asarray(res8.state.vel)[live8],
                               np.asarray(res1.state.vel)[live1],
                               rtol=1e-5, atol=1e-4)


def test_single_device_compaction_rebuilds_step(monkeypatch,
                                                kernel_interpreter):
    """Capacity-derived step choices (split-dispatch n_splits) must be
    rebuilt after a shards==1 compaction: a stale build kept a compacted
    run paying the original capacity's dispatch count per step."""
    import nbodyax.driver as drv
    calls = []
    orig = drv.build_step

    def spy(cfg, capacity=0, **kw):
        step = orig(cfg, capacity=capacity, **kw)
        calls.append((capacity, bool(getattr(step, "_host_loop", False))))
        return step

    monkeypatch.setattr(drv, "build_step", spy)
    # shrink the per-dispatch pair budget so 512 slots needs a split step
    # (3 dispatches) while the compacted bucket fits in one
    monkeypatch.setattr(drv, "MAX_PAIRS_PER_DISPATCH", 1e5)
    cfg = SimConfig(particle_count=512, total_iterations=30,
                    field_width=2000, field_height=2000,
                    save_images=False, log_every=0, compact_every=10,
                    backend="pallas")
    res = drv.run_simulation(cfg, quiet=True)
    assert res.state.capacity < 512
    assert calls[0] == (512, True)          # initial build: split/host-loop
    assert len(calls) >= 2                  # compaction rebuilt the step
    assert calls[-1][0] == res.state.capacity
    assert calls[-1][1] is False            # small bucket: one dispatch


@pytest.mark.slow
def test_drift_probe_fires_off_log_cadence(monkeypatch):
    """Merger-phase hardening: with bhAdapt on, fast alive-count drops
    trigger bh health probes at WINDOW boundaries, not just log points
    (r4 soak: a 50-step probe gap accumulated 424k bodies over the
    partner cap — each silently skipping collision physics that step)."""
    import nbodyax.driver as drv
    import nbodyax.physics.barneshut as bh
    calls = []
    orig = bh.bh_health

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(bh, "bh_health", spy)
    # no log/checkpoint cadence at all: every probe recorded here is an
    # off-cadence drift probe
    cfg = SimConfig(particle_count=512, total_iterations=200,
                    field_width=2000, field_height=2000,
                    save_images=False, log_every=0,
                    force_model="bh", backend="jnp")
    res = drv.run_simulation(cfg, quiet=True)
    assert int(np.asarray(res.state.step)) == 200
    assert calls, "no drift probes fired in a merging run without logs"
