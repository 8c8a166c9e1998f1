"""Ring all-gather step: every shard sees all N bodies via ppermute hops.

The distributed generalization of the reference's rotating shared-memory tile
schedule — tile k for thread t starts at ``(t + 128k) mod N``
(/root/reference/src/nbody.cu:186) — lifted from CUDA thread blocks to mesh
devices: each shard keeps its resident i-bodies and accumulators; the j-tile
(pos/vel/mass/radius + its global offset) circulates around the ring with
``lax.ppermute``. After P hops every shard has folded all N bodies into its
accumulators, exactly the ring-attention dataflow with (pos, mass, radius) in
the KV role and force/merge partial sums as the running state (SURVEY.md
section 2.2/5). Because every accumulator is associative (pairwise.py), hop
order doesn't matter beyond f32 rounding.

The next tile's ppermute is issued before the current tile's compute so XLA's
async collectives overlap communication with the O((N/P)^2 * N) pair math.

Merge resolution:
- reference / elastic / none: purely local per-i given the accumulators.
- momentum: merge trees span shards, so the per-body parent pointers (plus the
  state needed for the conserving update) are all-gathered, resolved
  replicated (pointer doubling is O(N log N), negligible next to O(N^2/P)
  pair math), and the local slice extracted.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from nbodyax.config import SimConfig
from nbodyax.physics.collisions import resolve_collisions
from nbodyax.physics.pairwise import (PairAccumulators, combine_accumulators,
                                      empty_accumulators,
                                      pair_accumulators_chunk)
from nbodyax.physics.step import PhysicsParams
from nbodyax.sharding.mesh import AXIS, make_mesh
from nbodyax.state import SimState

__all__ = ["ring_accumulators", "make_sharded_step", "make_local_accum_fn"]


def make_local_accum_fn(backend: str, p: PhysicsParams):
    """(pi, vi, mi, ri, i_off, pos_j, vel_j, mass_j, radius_j, j_off) ->
    PairAccumulators for the local i bodies against one j tile."""
    from nbodyax.backends import resolve_backend
    backend = resolve_backend(backend)

    if backend == "pallas":
        from nbodyax.physics.kernels import (body_features, decode_raw,
                                             tile_accumulators_raw)

        def accum(pi, vi, mi, ri, i_off, pj, vj, mj, rj, j_off):
            dim = pi.shape[-1]
            fi = body_features(pi, vi, mi, ri)
            fj = body_features(pj, vj, mj, rj).T
            raw, par = tile_accumulators_raw(fi, fj, i_off, j_off,
                                             mode=p.collision_mode, eps=p.eps,
                                             growth_rate=p.growth_rate,
                                             dim=dim)
            return decode_raw(raw, par, i_off, mi, p.collision_mode, dim=dim)
        return accum

    def accum(pi, vi, mi, ri, i_off, pj, vj, mj, rj, j_off):
        n_i, n_j = pi.shape[0], pj.shape[0]
        ii = jnp.asarray(i_off, jnp.int32) + lax.broadcasted_iota(
            jnp.int32, (n_i, 1), 0).squeeze(-1)
        jj = jnp.asarray(j_off, jnp.int32) + lax.broadcasted_iota(
            jnp.int32, (n_j, 1), 0).squeeze(-1)
        return pair_accumulators_chunk(
            pi, vi, mi, ri, ii, pj, vj, mj, rj, jj,
            eps2=jnp.float32(p.eps) ** 2,
            growth_rate=jnp.float32(p.growth_rate), mode=p.collision_mode)
    return accum


def ring_accumulators(pos, vel, mass, radius, *, n_shards: int,
                      accum_fn: Callable,
                      need_vel: bool = True) -> PairAccumulators:
    """Inside shard_map: fold all remote j tiles into local i accumulators.

    Arguments are the *local* shard arrays [N/P, ...]. Returns local-i
    accumulators identical (up to f32 rounding) to the single-device pass.

    ``need_vel=False`` (gravity/merge modes — only the elastic impulse reads
    partner velocities) drops vel from the circulating tile: 8 of 24 bytes
    per body per hop of interconnect traffic saved.
    """
    n_local = pos.shape[0]
    me = lax.axis_index(AXIS)
    i_off = me * n_local

    acc = empty_accumulators(
        i_off + lax.broadcasted_iota(jnp.int32, (n_local, 1), 0).squeeze(-1),
        dim=pos.shape[-1])
    # circulate (j data, j offset): each hop we receive from device me+1,
    # so after hop h we hold the tile of shard (me + h) mod P
    perm = [((s + 1) % n_shards, s) for s in range(n_shards)]
    zero_vel = jnp.zeros_like(vel)
    tile = ((pos, vel, mass, radius) if need_vel
            else (pos, mass, radius)) + (jnp.asarray(i_off, jnp.int32),)
    for hop in range(n_shards):
        if hop + 1 < n_shards:
            next_tile = jax.tree.map(lambda t: lax.ppermute(t, AXIS, perm),
                                     tile)
        else:
            next_tile = tile
        if need_vel:
            pj, vj, mj, rj, j_off = tile
        else:
            (pj, mj, rj, j_off), vj = tile, zero_vel
        acc = combine_accumulators(
            acc, accum_fn(pos, vel, mass, radius, i_off, pj, vj, mj, rj, j_off))
        tile = next_tile
    return acc


def resolve_collisions_sharded(pos, vel, mass, radius, acc, mode,
                               restitution=1.0):
    """Collision resolution inside a ``shard_map`` body (local arrays, named
    axis AXIS in scope). reference/elastic/none resolve purely locally;
    momentum-mode merge trees span shards, so the resolve runs replicated on
    all-gathered arrays (pointer doubling is O(N log N), negligible next to
    the pair math) and each shard keeps its own slice. Shared by the exact
    ring step and the sharded bh step."""
    if mode != "momentum":
        return resolve_collisions(pos, vel, mass, radius, acc, mode=mode,
                                  restitution=restitution)
    g = lambda x: lax.all_gather(x, AXIS, tiled=True)
    acc_g = jax.tree.map(g, acc)
    out_g = resolve_collisions(g(pos), g(vel), g(mass), g(radius), acc_g,
                               mode="momentum")
    me = lax.axis_index(AXIS)
    n_local = pos.shape[0]
    sl = lambda x: lax.dynamic_slice_in_dim(x, me * n_local, n_local)
    return tuple(sl(x) for x in out_g)


def make_sharded_step(cfg: SimConfig, p: PhysicsParams,
                      mesh: Mesh = None) -> Callable[[SimState], SimState]:
    """jit-compiled full step over a sharded SimState.

    Physics order matches physics/step.py exactly (euler or leapfrog); the
    only differences are where the pair accumulators come from (the ring —
    leapfrog's KDK runs it twice per step) and that momentum-mode merge
    resolution all-gathers.
    """
    if mesh is None:
        mesh = make_mesh(cfg.shards)
    n_shards = mesh.devices.size
    accum_fn = make_local_accum_fn(cfg.backend, p)

    def local_step(pos, vel, mass, radius):
        from nbodyax.physics.step import (finish_euler, finish_leapfrog,
                                          half_kick_drift, step_dt)

        ring = partial(ring_accumulators, n_shards=n_shards,
                       accum_fn=accum_fn,
                       need_vel=p.collision_mode == "elastic")
        acc = ring(pos, vel, mass, radius)
        pos2, vel2, mass2, radius2 = resolve_collisions_sharded(
            pos, vel, mass, radius, acc, p.collision_mode,
            restitution=p.restitution)
        # adaptiveDt: local per-shard bound, pmin'd so every shard steps
        # with the identical lockstep dt (a replicated scalar)
        dt = step_dt(vel2, mass2, radius2, acc.force, p, axis_name=AXIS)

        if p.integrator == "euler":
            return finish_euler(pos2, vel2, mass2, radius2, radius,
                                acc.force, p, dt=dt) + (dt,)
        if p.integrator == "yoshida4":
            from nbodyax.physics.step import yoshida4_tail
            return yoshida4_tail(pos2, vel2, mass2, radius2, acc.force,
                                 ring, p, dt=dt) + (dt,)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt=dt)
        acc2 = ring(new_pos, v_half, mass2, radius2)  # KDK second force pass
        return finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                               acc2.force, p, dt=dt) + (dt,)

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False)

    @jax.jit
    def step(state: SimState) -> SimState:
        pos, vel, mass, radius, dt = sharded(state.pos, state.vel,
                                             state.mass, state.radius)
        return SimState(pos, vel, mass, radius, state.step + 1,
                        state.sim_time + dt)

    return step
