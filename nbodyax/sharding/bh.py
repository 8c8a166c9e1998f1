"""Sharded Barnes-Hut step: compute-parallel hierarchical gravity.

Design: bodies stay index-sharded (same placement as the exact ring); each
step the full body set is all-gathered, every shard builds the
(deterministic, identical) quadtree grids and sorted partner structure from
the gathered arrays, and evaluates the per-CELL near+far passes for its own
contiguous 1/P slice of finest cells (plus 1/P of the crowded-cell
completion list). Compute scales with the device count; memory is O(N) per
device.

Cell-range (not body-range) sharding keeps the per-cell shared-window
gathers — the single-chip bh speedup (barneshut._near_field_cells /
_far_force_cells) — intact across shards: every cell's window is still
gathered exactly once, by exactly one shard. Each body's accumulators are
computed entirely by the shard owning its finest cell, so the cross-shard
merge degenerates from the accumulator monoid to a sum of identity-rebased
lanes, and rides one ``psum_scatter`` that hands every shard exactly its
local body slice (no second gather).

Why compute-parallel is the right trade at the 4M/8-shard target (per-device
accounting):

- **Interconnect**: one all_gather of (pos, vel, mass, radius) = 24 B/body
  (96 MB at N=4M received per device per pass) + one psum_scatter of the
  merged accumulator lanes (~(2*dim+4) f32 = 32 B/body in 2-D). At NVLink's
  450 GB/s each way that is well under a millisecond, small next to an
  O(N*levels) bh evaluation at this N. Momentum mode gathers the
  accumulators back once more (~36 B/body) — still noise.
- **Device memory**: gathered arrays (24 B/body) + sorted packed partner
  features (24 B/body: 6 f32 lanes — 8 in elastic mode, which also packs
  partner velocities; ids split across two exactly-f32-representable
  lanes, exact at any i32 N, barneshut._pack_id) + sort/index arrays
  (~12 B/body) +
  level grids (24 B * 4^levels, ~6 MB at levels=10)
  ~= 60-68 B/body ~= 240-272 MB at N=4M on an 80 GB card.
- Therefore O(N) replication only becomes a binding constraint beyond ~10^8
  bodies; space-partitioned sharding (contiguous cell ranges per shard +
  ring-halo exchange, O(N/P) memory) buys nothing at any currently
  reachable scale.

Collision resolution and integration mirror sharding/ring.py exactly.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from nbodyax.config import SimConfig
from nbodyax.backends import _resolve_near
from nbodyax.physics.barneshut import bh_cellrange_accumulators
from nbodyax.physics.step import (PhysicsParams, finish_euler,
                                  finish_leapfrog, half_kick_drift)
from nbodyax.sharding.mesh import AXIS, make_mesh
from nbodyax.sharding.ring import resolve_collisions_sharded
from nbodyax.state import SimState

__all__ = ["make_sharded_bh_step"]


def make_sharded_bh_step(cfg: SimConfig,
                         p: PhysicsParams,
                         mesh: Mesh = None) -> Callable[[SimState], SimState]:
    if mesh is None:
        mesh = make_mesh(cfg.shards)

    nshards = int(mesh.devices.size)

    def local_step(pos, vel, mass, radius):
        n_local = pos.shape[0]
        n = n_local * nshards
        me = lax.axis_index(AXIS)
        g = lambda x: lax.all_gather(x, AXIS, tiled=True)
        idx_g = jnp.arange(n, dtype=jnp.int32)

        def bh_acc(lp, lv, lm, lr):
            """Gather the full body set, evaluate this shard's cell range,
            merge to local body slices via one psum_scatter.

            Disjoint cell ranges mean each body row is non-identity on
            exactly one shard, so the monoid merge is a sum once every lane
            is rebased to additive identity 0: died rides as i32, parent as
            (parent - global_index). best_mass is not consumed downstream
            (resolve_collisions uses parent only) and is returned as its
            identity."""
            acc = bh_cellrange_accumulators(
                g(lp), g(lv), g(lm), g(lr), me, nshards,
                eps=p.eps, growth_rate=p.growth_rate, mode=p.collision_mode,
                levels=cfg.bh_levels, ring=cfg.bh_ring,
                neighbor_k=cfg.bh_neighbor_k, order=cfg.bh_order,
                far=getattr(cfg, "bh_far", "fmm"),
                near=_resolve_near(cfg),
                comp_cap=getattr(cfg, "bh_comp_cap", 0),
                n_giants=getattr(cfg, "bh_giants", 1024))
            sc = lambda x: lax.psum_scatter(x, AXIS, scatter_dimension=0,
                                            tiled=True)
            i_loc = me * n_local + jnp.arange(n_local, dtype=jnp.int32)
            return acc._replace(
                force=sc(acc.force),
                gained_mass=sc(acc.gained_mass),
                gained_radius=sc(acc.gained_radius),
                died=sc(acc.died.astype(jnp.int32)) > 0,
                best_mass=jnp.full((n_local,), -jnp.inf, jnp.float32),
                parent=sc(acc.parent - idx_g) + i_loc,
                dv=sc(acc.dv))

        acc = bh_acc(pos, vel, mass, radius)
        pos2, vel2, mass2, radius2 = resolve_collisions_sharded(
            pos, vel, mass, radius, acc, p.collision_mode,
            restitution=p.restitution)
        from nbodyax.physics.step import step_dt
        # adaptiveDt: pmin makes the lockstep dt identical on every shard
        dt = step_dt(vel2, mass2, radius2, acc.force, p, axis_name=AXIS)

        if p.integrator == "euler":
            return finish_euler(pos2, vel2, mass2, radius2, radius,
                                acc.force, p, dt=dt) + (dt,)
        if p.integrator == "yoshida4":
            from nbodyax.physics.step import yoshida4_tail
            return yoshida4_tail(pos2, vel2, mass2, radius2, acc.force,
                                 bh_acc, p, dt=dt) + (dt,)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt=dt)
        acc2 = bh_acc(new_pos, v_half, mass2, radius2)  # KDK second pass
        return finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                               acc2.force, p, dt=dt) + (dt,)

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(AXIS),) * 4, out_specs=(P(AXIS),) * 4 + (P(),),
        check_vma=False)

    @jax.jit
    def step(state: SimState) -> SimState:
        pos, vel, mass, radius, dt = sharded(state.pos, state.vel,
                                             state.mass, state.radius)
        return SimState(pos, vel, mass, radius, state.step + 1,
                        state.sim_time + dt)

    return step
