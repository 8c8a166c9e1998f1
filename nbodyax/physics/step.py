"""Full simulation step: forces -> collisions -> boundary -> integrate.

Recomposition of the reference's per-iteration device work
(``ComputeForces`` + ``MoveBodies``, /root/reference/src/nbody.cu:139-292) into
one jit-compiled function over the fixed-capacity SimState pytree. The exact
reference order of operations is preserved in reference mode
(SURVEY.md section 3.2):

1. pairwise accumulators from step-start state (nbody.cu:182-242);
2. merge bookkeeping commits to mass/radius (nbody.cu:245-246,289-290);
3. ``accel = G * force`` (nbody.cu:250, G = 6.67408e-11f);
4. boundary bounce flips the *old* velocity where ``pos + accel*dt`` would
   leave ``[-(field - r), field - r]`` per axis — quirk Q6: the displacement
   probe uses accel*dt, not vel*dt, and the position is never clamped
   (nbody.cu:256-261). The radius used is the *pre-merge* radius;
5. ``vel' = flipped_vel + accel*dt`` (nbody.cu:264);
6. ``pos' = pos + vel'*dt`` — semi-implicit Euler (nbody.cu:288).

Alternatives (new, config-selectable): ``boundaryMode=clamp`` predicts with the
real displacement ``vel'*dt`` and clamps positions into the field;
``integrator=leapfrog`` runs kick-drift-kick with a second force pass.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nbodyax.physics.collisions import resolve_collisions
from nbodyax.physics.pairwise import PairAccumulators, pair_accumulators
from nbodyax.state import SimState

__all__ = ["PhysicsParams", "make_step", "step_dt", "yoshida4_tail",
           "GRAV_CONSTANT"]

# np (not jnp) scalar: importing this module must not initialize a JAX backend
GRAV_CONSTANT = np.float32(6.67408e-11)  # nbody.cu:37


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Static physics configuration (hashable; closed over by the jitted step)."""

    dt: float = 0.2
    field_width: float = 100000.0
    field_height: float = 100000.0
    field_depth: float = 100000.0         # z half-extent (3-D extension)
    growth_rate: float = 0.1
    eps: float = 0.0                      # softening; 0 = reference (Q4)
    collision_mode: str = "reference"
    restitution: float = 1.0              # elastic-mode e: impulse scaled by
                                          # (1+e)/2 at the commit (hoists out
                                          # of the pair sum; e=1 is bit-exact
                                          # the original elastic path)
    boundary_mode: str = "reference"
    wall_restitution: float = 1.0         # clamp-mode wall bounce scale e_w
                                          # (reference mode ignores it: the
                                          # Q6 sign-flip is part of the spec)
    integrator: str = "euler"
    # adaptive global timestep (beyond-reference, off by default: the
    # reference is fixed-dt, nbody.cu:264,288). When on, each step uses
    # dt = clip(min_i min(eta*sqrt(r_i/|a_i|), eta*r_i/|v_i|), lo, hi)
    # over alive bodies — one LOCKSTEP dt per step (per-body dt tiers
    # would break the all-pairs collision pass). The velocity
    # term bounds per-step motion to a fraction of each body's own radius,
    # which is what keeps fast bodies from tunneling through collision
    # partners between overlap tests.
    adaptive_dt: bool = False
    dt_eta: float = 0.25                  # safety factor (both criteria)
    dt_min: float = 0.0                   # 0 -> dt_max / 1024
    dt_max: float = 0.0                   # 0 -> the configured fixed dt

    @classmethod
    def from_config(cls, cfg) -> "PhysicsParams":
        return cls(dt=float(jnp.float32(cfg.timestep)),
                   field_width=float(cfg.field_width),
                   field_height=float(cfg.field_height),
                   field_depth=float(getattr(cfg, "field_depth", 0)
                                    or cfg.field_width),
                   growth_rate=float(jnp.float32(cfg.growth_rate)),
                   eps=float(cfg.softening),
                   collision_mode=cfg.collision_mode,
                   restitution=float(getattr(cfg, "restitution", 1.0)),
                   boundary_mode=cfg.boundary_mode,
                   wall_restitution=float(getattr(cfg, "wall_restitution",
                                                  1.0)),
                   integrator=cfg.integrator,
                   adaptive_dt=bool(getattr(cfg, "adaptive_dt", False)),
                   dt_eta=float(getattr(cfg, "dt_eta", 0.25)),
                   dt_min=float(getattr(cfg, "dt_min", 0.0)),
                   dt_max=float(getattr(cfg, "dt_max", 0.0)))

    @property
    def dt_bounds(self):
        """Resolved (dt_min, dt_max) for the adaptive clip."""
        hi = self.dt_max or self.dt
        return (self.dt_min or hi / 1024.0, hi)


AccumFn = Callable[..., PairAccumulators]


def step_dt(vel, mass, radius, force, p: PhysicsParams, axis_name=None):
    """The dt this step integrates with: the static configured dt, or (under
    ``adaptiveDt``) one global stability-bounded value computed from the
    just-evaluated forces — dt = clip(min over alive bodies of
    min(eta*sqrt(r/|a|), eta*r/|v|), dt_min, dt_max). Inputs are the
    post-collision arrays (what the kick/drift actually integrates).
    ``axis_name``: inside a ``shard_map`` body, the mesh axis to ``pmin``
    over so every shard steps with the identical lockstep dt."""
    if not p.adaptive_dt:
        return jnp.float32(p.dt)
    accel = force * GRAV_CONSTANT
    amag = jnp.sqrt(jnp.sum(accel * accel, axis=-1))
    vmag = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    tiny = jnp.float32(1e-30)
    dt_a = p.dt_eta * jnp.sqrt(radius / jnp.maximum(amag, tiny))
    dt_v = p.dt_eta * radius / jnp.maximum(vmag, tiny)
    dt_i = jnp.where(mass > 0, jnp.minimum(dt_a, dt_v), jnp.inf)
    dt = jnp.min(dt_i)          # all-dead -> inf -> clips to dt_max
    if axis_name is not None:
        dt = jax.lax.pmin(dt, axis_name)
    lo, hi = p.dt_bounds
    return jnp.clip(dt, jnp.float32(lo), jnp.float32(hi))


def finish_euler(pos2, vel2, mass2, radius2, pre_radius, force,
                 p: PhysicsParams, dt=None):
    """Post-collision tail of a step: boundary -> kick -> drift -> dead-slot
    freeze, in the reference's exact order (SURVEY.md section 3.2). Takes the
    post-collision arrays plus the pre-merge radius and the un-scaled force
    sum; returns (pos, vel, mass, radius). ``dt`` overrides the static
    configured value (adaptiveDt — see ``step_dt``). Shared by the
    single-dispatch step, the split-dispatch step for huge N, and the
    sharded ring step."""
    dt = jnp.float32(p.dt) if dt is None else dt
    accel = force * GRAV_CONSTANT
    if p.boundary_mode == "reference":
        vel2 = _boundary_flip(pos2, vel2, pre_radius, accel * dt, p)
    new_vel = vel2 + accel * dt                       # nbody.cu:264
    new_pos = pos2 + new_vel * dt                     # nbody.cu:288
    if p.boundary_mode == "clamp":
        probe = new_pos - pos2
        new_vel = _boundary_flip(pos2, new_vel, radius2, probe, p)
        new_pos = _clamp_positions(pos2 + new_vel * dt, radius2, p)
    # freeze dead slots: the reference removes them outright
    # (nbody.cu:488-510); freezing is the fixed-capacity analog and keeps
    # their stale coordinates from drifting toward overflow over long runs
    alive = (mass2 > 0)[:, None]
    new_vel = jnp.where(alive, new_vel, 0.0)
    new_pos = jnp.where(alive, new_pos, pos2)
    return new_pos, new_vel, mass2, radius2


def apply_euler_update(state: SimState, acc: PairAccumulators,
                       p: PhysicsParams) -> SimState:
    """Collision commit + finish_euler on a SimState."""
    pos2, vel2, mass2, radius2 = resolve_collisions(
        state.pos, state.vel, state.mass, state.radius, acc,
        mode=p.collision_mode, restitution=p.restitution)
    dt = step_dt(vel2, mass2, radius2, acc.force, p)
    out = finish_euler(pos2, vel2, mass2, radius2, state.radius, acc.force,
                       p, dt=dt)
    return SimState(*out, state.step + 1, state.sim_time + dt)


def half_kick_drift(pos2, vel2, force, p: PhysicsParams, dt=None):
    """Leapfrog first half (post-collision): half kick + full drift.
    Returns (v_half, new_pos). ``dt`` overrides the static configured value
    (adaptiveDt: chosen once at the first kick, used for the WHOLE KDK step
    — the standard adaptive-leapfrog structure). Shared by the
    single-dispatch, split-dispatch, ring-sharded, and bh-sharded leapfrog
    steps."""
    dt = jnp.float32(p.dt) if dt is None else dt
    accel = force * GRAV_CONSTANT
    v_half = vel2 + accel * (dt / 2)
    return v_half, pos2 + v_half * dt


def finish_leapfrog(pos2, new_pos, v_half, mass2, radius2, force2,
                    p: PhysicsParams, dt=None):
    """Leapfrog second half: final half kick from the second force pass,
    then boundary + dead-slot freeze. Boundary semantics mirror the euler
    modes as closely as the KDK structure allows: ``reference`` flips
    velocity on an accel*dt probe and never clamps (quirk Q6 preserved);
    ``clamp`` predicts with the real displacement and clamps positions.
    ``dt`` must be the same value the first half used."""
    dt = jnp.float32(p.dt) if dt is None else dt
    accel2 = force2 * GRAV_CONSTANT
    new_vel = v_half + accel2 * (dt / 2)
    if p.boundary_mode == "reference":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, accel2 * dt, p)
    elif p.boundary_mode == "clamp":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, new_vel * dt, p)
        new_pos = _clamp_positions(new_pos, radius2, p)
    alive = (mass2 > 0)[:, None]
    new_vel = jnp.where(alive, new_vel, 0.0)
    new_pos = jnp.where(alive, new_pos, pos2)
    return new_pos, new_vel, mass2, radius2


# Yoshida (1990) 4th-order symplectic composition: three leapfrog substeps
# scaled by (w1, w0, w1). The negative middle substep is what cancels the
# 2nd-order error term; coefficients are exact in f64 and rounded once to f32.
_YOSH_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_YOSH_W0 = 1.0 - 2.0 * _YOSH_W1


def yoshida4_tail(pos2, vel2, mass2, radius2, force1, accum_fn,
                  p: PhysicsParams, dt=None):
    """4th-order symplectic tail (post-collision): the three scaled leapfrog
    substeps merged into a kick-drift chain with kick coefficients
    c = (w1/2, (w0+w1)/2, (w0+w1)/2, w1/2) and drift coefficients
    d = (w1, w0, w1) — three *additional* force passes beyond the step-start
    pass whose force is ``force1``. Collision resolution happened once at the
    step-start pass (same placement as leapfrog); boundary handling and the
    dead-slot freeze run once at the end, mirroring ``finish_leapfrog``.
    ``accum_fn(pos, vel, mass, radius) -> PairAccumulators`` supplies the
    mid-step force passes, so the same tail serves the single-dispatch, ring-
    sharded, and bh-sharded steps."""
    dt = jnp.float32(p.dt) if dt is None else dt
    c = (_YOSH_W1 / 2, (_YOSH_W0 + _YOSH_W1) / 2,
         (_YOSH_W0 + _YOSH_W1) / 2, _YOSH_W1 / 2)
    d = (_YOSH_W1, _YOSH_W0, _YOSH_W1)
    v = vel2 + force1 * GRAV_CONSTANT * (np.float32(c[0]) * dt)
    x = pos2 + v * (np.float32(d[0]) * dt)
    for i in (1, 2):
        acc = accum_fn(x, v, mass2, radius2)
        v = v + acc.force * GRAV_CONSTANT * (np.float32(c[i]) * dt)
        x = x + v * (np.float32(d[i]) * dt)
    a4 = accum_fn(x, v, mass2, radius2).force * GRAV_CONSTANT
    new_vel = v + a4 * (np.float32(c[3]) * dt)
    new_pos = x
    if p.boundary_mode == "reference":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, a4 * dt, p)
    elif p.boundary_mode == "clamp":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, new_vel * dt, p)
        new_pos = _clamp_positions(new_pos, radius2, p)
    alive = (mass2 > 0)[:, None]
    new_vel = jnp.where(alive, new_vel, 0.0)
    new_pos = jnp.where(alive, new_pos, pos2)
    return new_pos, new_vel, mass2, radius2


def _field_vec(p: PhysicsParams, dim: int):
    """Per-axis field half-extents; the z extent only exists in 3-D runs."""
    return jnp.array([p.field_width, p.field_height,
                      p.field_depth][:dim], jnp.float32)


def _boundary_flip(pos, vel, radius, probe_disp, p: PhysicsParams):
    """Reflective boundary: flip velocity components where pos + probe_disp
    would exit the per-axis interval [-(field - r), field - r]
    (nbody.cu:256-261)."""
    field = _field_vec(p, pos.shape[-1])
    limit = field[None, :] - radius[:, None]
    pred = pos + probe_disp
    out = (pred > limit) | (pred < -limit)
    flipped = -vel
    if p.boundary_mode == "clamp" and p.wall_restitution != 1.0:
        # partially inelastic wall: scale the reflected component by e_w.
        # Only in clamp mode — the reference-mode sign-flip is spec (Q6).
        flipped = np.float32(-p.wall_restitution) * vel
    return jnp.where(out, flipped, vel)


def _clamp_positions(pos, radius, p: PhysicsParams):
    field = _field_vec(p, pos.shape[-1])
    limit = field[None, :] - radius[:, None]
    return jnp.clip(pos, -limit, limit)


def make_step(p: PhysicsParams,
              accum_fn: Optional[AccumFn] = None,
              chunk: Optional[int] = None) -> Callable[[SimState], SimState]:
    """Build the jittable step function.

    ``accum_fn(pos, vel, mass, radius) -> PairAccumulators`` selects the
    all-pairs backend: the chunked jnp pass (default; the oracle), the Pallas
    kernel (physics/kernels.py), or the cross-shard ring (sharding/ring.py).
    """
    if accum_fn is None:
        accum_fn = partial(pair_accumulators, eps=p.eps,
                           growth_rate=p.growth_rate, mode=p.collision_mode,
                           chunk=chunk)
    def euler_step(state: SimState) -> SimState:
        with jax.named_scope("pair_accumulators"):
            acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        with jax.named_scope("integrate"):
            return apply_euler_update(state, acc, p)

    def leapfrog_step(state: SimState) -> SimState:
        """Kick-drift-kick with collision resolution at the first kick."""
        acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        pos2, vel2, mass2, radius2 = resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)
        dt = step_dt(vel2, mass2, radius2, acc.force, p)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt=dt)
        acc2 = accum_fn(new_pos, v_half, mass2, radius2)
        out = finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                              acc2.force, p, dt=dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    def yoshida_step(state: SimState) -> SimState:
        """4th-order composition; collisions resolve at the first kick."""
        acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        pos2, vel2, mass2, radius2 = resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)
        dt = step_dt(vel2, mass2, radius2, acc.force, p)
        out = yoshida4_tail(pos2, vel2, mass2, radius2, acc.force,
                            accum_fn, p, dt=dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    step = {"euler": euler_step, "leapfrog": leapfrog_step,
            "yoshida4": yoshida_step}[p.integrator]
    return jax.jit(step)


def make_split_step(p: PhysicsParams, n_splits: int,
                    tile_i: Optional[int] = None,
                    tile_j: Optional[int] = None,
                    dim: int = 2) -> Callable[[SimState], SimState]:
    """Huge-N single-device step: the pair pass runs as ``n_splits``
    separate device dispatches over i-ranges, then one dispatch commits the
    update.

    Splitting the i-grid bounds each dispatch (~N^2/n_splits pairs) with
    zero redundant work, so no single device execution runs for minutes.
    Host orchestration between dispatches; leapfrog runs the split pair pass
    twice per step (KDK's second force evaluation). The pair pass is the
    kernel of physics/kernels.py.
    """
    if p.integrator == "yoshida4":
        raise ValueError(
            "integrator=yoshida4 is not supported on the split-dispatch "
            "huge-N path (four full pair passes per step would quadruple "
            "the dispatch budget); use forceModel=bh or "
            "integrator=leapfrog at this N")
    from nbodyax.physics.kernels import (DEFAULT_TILE_I, DEFAULT_TILE_J,
                                         body_features, decode_raw,
                                         tile_accumulators_raw)
    ti = tile_i or DEFAULT_TILE_I
    tj = tile_j or DEFAULT_TILE_J

    @jax.jit
    def feats_fn(pos, vel, mass, radius):
        f = body_features(pos, vel, mass, radius)
        return f, f.T

    @partial(jax.jit, static_argnames=())
    def chunk_raw(fi_chunk, fjt, off):
        return tile_accumulators_raw(fi_chunk, fjt, off, 0,
                                     mode=p.collision_mode, eps=p.eps,
                                     growth_rate=p.growth_rate,
                                     tile_i=ti, tile_j=tj, dim=dim)

    def split_accum(pos, vel, mass, radius):
        """n_splits bounded dispatches over i-ranges -> (raw, parent)."""
        n = pos.shape[0]
        csize = -(-n // n_splits)
        fi, fjt = feats_fn(pos, vel, mass, radius)
        raws, pars = [], []
        for c in range(n_splits):
            s = c * csize
            e = min(n, s + csize)
            if s >= e:
                break
            r, pr = chunk_raw(jax.lax.slice_in_dim(fi, s, e), fjt, s)
            raws.append(r)
            pars.append(pr)
        raw = jnp.concatenate(raws, axis=0)
        par = (jnp.concatenate(pars, axis=0) if pars[0] is not None else None)
        return raw, par

    @jax.jit
    def commit_euler(state: SimState, raw, par) -> SimState:
        acc = decode_raw(raw, par, 0, state.mass, p.collision_mode,
                         dim=dim)
        return apply_euler_update(state, acc, p)

    @jax.jit
    def begin_leapfrog(state: SimState, raw, par):
        acc = decode_raw(raw, par, 0, state.mass, p.collision_mode,
                         dim=dim)
        pos2, vel2, mass2, radius2 = resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)
        dt = step_dt(vel2, mass2, radius2, acc.force, p)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt=dt)
        return pos2, new_pos, v_half, mass2, radius2, dt

    @jax.jit
    def commit_leapfrog(step_count, sim_time, pos2, new_pos, v_half, mass2,
                        radius2, dt, raw2, par2) -> SimState:
        acc2 = decode_raw(raw2, par2, 0, mass2, p.collision_mode,
                          dim=dim)
        out = finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                              acc2.force, p, dt=dt)
        return SimState(*out, step_count + 1, sim_time + dt)

    def step(state: SimState) -> SimState:
        raw, par = split_accum(state.pos, state.vel, state.mass, state.radius)
        if p.integrator == "euler":
            return commit_euler(state, raw, par)
        *mid, dt = begin_leapfrog(state, raw, par)
        raw2, par2 = split_accum(mid[1], mid[2], mid[3], mid[4])
        return commit_leapfrog(state.step, state.sim_time, *mid, dt,
                               raw2, par2)

    return step
