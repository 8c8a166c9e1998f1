"""Differentiable rollouts (nbodyax.autodiff): gradient correctness.

The reference has no analog (forward-only CUDA); these tests pin the
framework-native capability: reverse-mode gradients through the full step
(gravity + collisions + boundary + integrator) match central finite
differences on a well-conditioned scene, stay finite through the discrete
collision modes, and are invariant to rematerialization.

Conditioning: everything here runs in f32, so the FD check needs a loss of
O(1) and position scales where an FD epsilon both moves the trajectory and
survives rounding. The scene below (pos ~ 1e2, G*m ~ 1e2) is built for
that; the shipped 1e5-field default scene is NOT FD-checkable in f32 (loss
~ 1e12 quantizes at ~1e5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbodyax.autodiff import make_loss, rollout
from nbodyax.config import SimConfig
from nbodyax.physics.pairwise import pair_accumulators
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.state import make_state

N = 16
SCALE = 100.0


def small_state(seed=0, dim=2, overlapping=False):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-SCALE, SCALE, (N, dim)).astype(np.float32)
    vel = rng.uniform(-1, 1, (N, dim)).astype(np.float32)
    # G = 6.674e-11: masses ~ 1e12 give accelerations ~ 1e2/d^2 — real
    # gravitational coupling at this scale, so force gradients carry signal
    mass = rng.uniform(0.5e12, 2e12, N).astype(np.float32)
    radius = rng.uniform(20, 60, N).astype(np.float32) if overlapping \
        else rng.uniform(0.5, 2.0, N).astype(np.float32)
    return make_state(pos, vel, mass, radius)


def small_step(mode="none", dim=2, integrator="euler"):
    cfg = SimConfig(particle_count=N, collision_mode=mode, backend="jnp",
                    softening=5.0, dimensions=dim, integrator=integrator,
                    field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    from functools import partial
    accum = partial(pair_accumulators, eps=p.eps,
                    growth_rate=p.growth_rate, mode=mode)
    return make_step(p, accum_fn=accum)


def target_loss(state):
    return jnp.sum((state.pos / SCALE) ** 2) / N


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_grad_matches_central_fd(integrator):
    step = small_step("none", integrator=integrator)
    state = small_state(1)
    loss = make_loss(step, 5, target_loss)
    g = jax.grad(lambda pos: loss(state._replace(pos=pos)))(state.pos)
    assert bool(jnp.all(jnp.isfinite(g)))

    # central FD on the 3 largest-gradient coordinates (best conditioned)
    gflat = np.abs(np.asarray(g)).ravel()
    idx = np.argsort(gflat)[-3:]
    eps = 0.05
    for flat in idx:
        i, d = divmod(int(flat), state.pos.shape[1])
        pp = np.asarray(state.pos).copy()
        pm = pp.copy()
        pp[i, d] += eps
        pm[i, d] -= eps
        fd = (float(loss(state._replace(pos=jnp.asarray(pp))))
              - float(loss(state._replace(pos=jnp.asarray(pm))))) / (2 * eps)
        ad = float(g[i, d])
        assert abs(ad - fd) <= 0.08 * max(abs(ad), abs(fd)), \
            (integrator, i, d, ad, fd)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_grad_finite_through_collision_modes(mode):
    # overlapping radii force real merge/bounce events inside the horizon;
    # gradients must stay finite (events contribute zero, not NaN)
    step = small_step(mode)
    state = small_state(2, overlapping=True)
    loss = make_loss(step, 4, target_loss)
    val = float(loss(state))
    g = jax.grad(lambda pos: loss(state._replace(pos=pos)))(state.pos)
    gv = jax.grad(lambda vel: loss(state._replace(vel=vel)))(state.vel)
    assert np.isfinite(val)
    assert bool(jnp.all(jnp.isfinite(g))) and bool(jnp.all(jnp.isfinite(gv)))
    assert float(jnp.abs(g).max()) > 0


def test_remat_matches_full_residuals():
    step = small_step("reference")
    state = small_state(3, overlapping=True)

    def loss(pos, remat):
        final, _ = rollout(step, state._replace(pos=pos), 4, remat=remat)
        return target_loss(final)

    g1 = jax.grad(lambda p: loss(p, True))(state.pos)
    g2 = jax.grad(lambda p: loss(p, False))(state.pos)
    # checkpoint re-runs the identical ops — gradients agree to f32 exactness
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-6, atol=1e-9)


def test_trajectory_loss_and_shapes():
    step = small_step("none")
    state = small_state(4)
    final, traj = rollout(step, state, 6, save_positions=True)
    assert traj.shape == (6, N, 2)
    np.testing.assert_array_equal(np.asarray(traj[-1]),
                                  np.asarray(final.pos))

    def traj_loss(vel):
        _, t = rollout(step, state._replace(vel=vel), 6,
                       save_positions=True)
        return jnp.mean((t / SCALE) ** 2)

    g = jax.grad(traj_loss)(state.vel)
    assert bool(jnp.all(jnp.isfinite(g))) and float(jnp.abs(g).max()) > 0


@pytest.mark.slow
def test_grad_through_sharded_ring_matches_single_device():
    # differentiable DISTRIBUTED simulation: reverse-mode flows through the
    # shard_map ring step (XLA differentiates ppermute/psum natively) and
    # must agree with the single-device gradient — same physics, different
    # collective dataflow, f32 reduction-order noise only
    from nbodyax.sharding.mesh import make_mesh
    from nbodyax.sharding.ring import make_sharded_step

    state = small_state(6)
    cfg = SimConfig(particle_count=N, collision_mode="reference",
                    backend="jnp", softening=5.0, shards=8,
                    field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    sstep = make_sharded_step(cfg, p, make_mesh(8))
    lstep = small_step("reference")

    def loss(step, pos):
        s = state._replace(pos=pos)
        for _ in range(3):
            s = step(s)
        return target_loss(s)

    gs = jax.grad(lambda pos: loss(sstep, pos))(state.pos)
    gl = jax.grad(lambda pos: loss(lstep, pos))(state.pos)
    scale = float(jnp.abs(gl).max())
    assert float(jnp.abs(gs - gl).max()) / scale < 1e-5


# ---------------------------------------------------------------------------
# Pallas-backend VJP (jax.custom_vjp in kernels.py over raw_reference)
# ---------------------------------------------------------------------------

def _accum_grads(fn, state, mode, eps, dim):
    """Grads of a channel-weighted scalar of the accumulators w.r.t. every
    differentiable state leaf — exercises force, gained mass/radius, dv and
    best-mass cotangents at once."""
    k = jnp.arange(state.pos.size, dtype=jnp.float32).reshape(state.pos.shape)

    def loss(pos, vel, mass, radius):
        acc = fn(pos, vel, mass, radius, eps=eps, growth_rate=0.1, mode=mode)
        out = jnp.sum(acc.force * jnp.cos(k))
        out = out + jnp.sum(acc.gained_mass) * 1e-12
        out = out + jnp.sum(acc.gained_radius)
        out = out + jnp.sum(acc.dv * jnp.sin(k))
        bm = acc.best_mass
        return out + 1e-12 * jnp.sum(jnp.where(jnp.isfinite(bm), bm, 0.0))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        state.pos, state.vel, state.mass, state.radius)


@pytest.mark.parametrize("mode,eps,dim", [
    ("none", 5.0, 2), ("reference", 0.0, 2), ("reference", 5.0, 3),
    ("momentum", 0.0, 2), ("elastic", 0.0, 2), ("elastic", 5.0, 3)])
def test_pallas_vjp_matches_jnp(mode, eps, dim):
    # the kernel's custom VJP must reproduce jax.grad of the jnp oracle
    # exactly (same event gating, incl. dead-body pairs): interpret mode on
    # CPU, overlapping radii so every collision channel carries signal, two
    # dead bodies so alive-gating is exercised
    from functools import partial

    from nbodyax.physics.kernels import pallas_pair_accumulators

    state = small_state(11, dim=dim, overlapping=True)
    state = state._replace(mass=state.mass.at[3].set(0.0).at[7].set(0.0))
    gj = _accum_grads(pair_accumulators, state, mode, eps, dim)
    gp = _accum_grads(partial(pallas_pair_accumulators, interpret=True),
                      state, mode, eps, dim)
    for name, a, b in zip(("pos", "vel", "mass", "radius"), gj, gp):
        a, b = np.asarray(a), np.asarray(b)
        assert np.all(np.isfinite(a)), (mode, name, "jnp grad not finite")
        scale = max(np.abs(a).max(), 1e-30)
        err = np.abs(a - b).max() / scale
        assert err < 3e-6, (mode, eps, dim, name, err)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_pallas_rollout_grad_matches_jnp(mode):
    # full 4-step rollout (collisions + boundary + integrator): gradients
    # w.r.t. initial pos/vel/mass through the Pallas backend == jnp backend
    from functools import partial

    from nbodyax.physics.kernels import pallas_pair_accumulators

    cfg = SimConfig(particle_count=N, collision_mode=mode, backend="jnp",
                    softening=5.0, field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    state = small_state(2, overlapping=True)
    steps = {
        "jnp": make_step(p, accum_fn=partial(
            pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
            mode=mode)),
        "pallas": make_step(p, accum_fn=partial(
            pallas_pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
            mode=mode, interpret=True))}
    grads = {}
    for name, step in steps.items():
        loss = make_loss(step, 4, target_loss)
        grads[name] = (
            jax.grad(lambda x: loss(state._replace(pos=x)))(state.pos),
            jax.grad(lambda x: loss(state._replace(vel=x)))(state.vel),
            jax.grad(lambda x: loss(state._replace(mass=x)))(state.mass))
    for leaf, a, b in zip(("pos", "vel", "mass"),
                          grads["jnp"], grads["pallas"]):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 5e-6, (mode, leaf)
        assert np.abs(a).max() > 0, (mode, leaf, "zero gradient")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_grad_through_sharded_pallas_ring(mode, kernel_interpreter):
    # the custom VJP composes with shard_map/ppermute: distributed Pallas
    # gradients == single-device jnp gradients (f32 reduction noise only)
    from nbodyax.sharding.mesh import make_mesh
    from nbodyax.sharding.ring import make_sharded_step

    state = small_state(6)
    cfg = SimConfig(particle_count=N, collision_mode=mode, backend="pallas",
                    softening=5.0, shards=8,
                    field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    sstep = make_sharded_step(cfg, p, make_mesh(8))
    lstep = small_step(mode)

    def loss(step, pos):
        s = state._replace(pos=pos)
        for _ in range(3):
            s = step(s)
        return target_loss(s)

    gs = jax.grad(lambda pos: loss(sstep, pos))(state.pos)
    gl = jax.grad(lambda pos: loss(lstep, pos))(state.pos)
    scale = float(jnp.abs(gl).max())
    assert float(jnp.abs(gs - gl).max()) / scale < 1e-5


def test_elastic_grad_finite_with_dead_bodies():
    # regression: the oracle's elastic coef divided by msum = m_i + m_j,
    # which is 0/0 on dead-dead pairs — masked in the VALUE but NaN in the
    # GRADIENT until the double-where guard (pairwise.py)
    step = small_step("elastic")
    state = small_state(4, overlapping=True)
    state = state._replace(mass=state.mass.at[0].set(0.0).at[5].set(0.0))
    loss = make_loss(step, 3, target_loss)
    g = jax.grad(lambda pos: loss(state._replace(pos=pos)))(state.pos)
    gm = jax.grad(lambda m: loss(state._replace(mass=m)))(state.mass)
    assert bool(jnp.all(jnp.isfinite(g))) and bool(jnp.all(jnp.isfinite(gm)))


def test_shooting_descends_under_jit():
    # the canonical adjoint use: steer body 0 onto a target by descending
    # the jitted gradient w.r.t. its initial velocity
    step = small_step("none")
    state = small_state(5)
    target = jnp.asarray([80.0, -40.0])
    steps = 5

    def loss(v0):
        s0 = state._replace(vel=state.vel.at[0].set(v0))
        final, _ = rollout(step, s0, steps)
        return jnp.sum(((final.pos[0] - target) / SCALE) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    v0 = state.vel[0]
    prev, g = vg(v0)
    prev = float(prev)
    history = [prev]
    for _ in range(8):
        # curvature ~ (steps*dt/SCALE)^2 = 1e-4 => stable lr up to ~1e4
        v0 = v0 - 2e3 * g
        val, g = vg(v0)
        history.append(float(val))
    assert history[-1] < 0.01 * history[0], history
