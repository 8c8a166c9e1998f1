"""Simulation state pytree.

Replacement for the reference's ``BodiesData`` contiguous SoA blob
(``/root/reference/src/nbody.cu:47-124``). Instead of a host-owned allocation
mirrored to the device with per-step PCIe round trips and host compaction
(nbody.cu:476-510, quirk Q9 in SURVEY.md), state is a fixed-capacity JAX pytree
that stays device-resident for the whole run. Dead bodies keep their slot with
``mass == 0`` — the same in-band death marker the reference kernel writes
(nbody.cu:245) — and are masked out of physics and rendering, so shapes stay
static and nothing ever recompiles as bodies merge.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SimState", "make_state", "alive_mask", "alive_count"]


class SimState(NamedTuple):
    """SoA body state. Leaves are device arrays; the tuple is a JAX pytree.

    pos:    f32[N, D]  positions (field coordinates, origin-centered;
                       D = 2 for reference scenes, 3 with dimensions=3)
    vel:    f32[N, D]  velocities
    mass:   f32[N]     masses; 0 means the slot is dead (nbody.cu:245,489-494)
    radius: f32[N]     radii
    step:   i32[]      completed step count (for checkpoint/resume)
    sim_time: f32[]    elapsed simulated time (sum of the dt of every
                       completed step — equals step*dt on fixed-dt runs,
                       meaningful observability under adaptiveDt; f32, so
                       ~7 significant digits over a run's horizon)
    """

    pos: jax.Array
    vel: jax.Array
    mass: jax.Array
    radius: jax.Array
    step: jax.Array
    sim_time: jax.Array = np.float32(0.0)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def make_state(pos, vel, mass, radius, step: int = 0,
               sim_time: float = 0.0) -> SimState:
    return SimState(
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.asarray(vel, jnp.float32),
        mass=jnp.asarray(mass, jnp.float32),
        radius=jnp.asarray(radius, jnp.float32),
        step=jnp.asarray(step, jnp.int32),
        sim_time=jnp.asarray(sim_time, jnp.float32),
    )


def alive_mask(state: SimState) -> jax.Array:
    """bool[N] — which slots hold live bodies (mass != 0, nbody.cu:490)."""
    return state.mass > 0


def alive_count(state: SimState) -> int:
    return int(jnp.sum(alive_mask(state)))


def to_numpy(state: SimState):
    """Host copies of all arrays (for checkpointing / inspection)."""
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def compact_state(state: SimState, *, min_capacity: int = 256,
                  slack: float = 1.25) -> SimState:
    """Shrink capacity to the next power-of-2 bucket above the live count.

    The device-side analog of the reference's per-step host compaction
    (/root/reference/src/nbody.cu:488-510): as merges kill bodies, the
    all-pairs cost should track the live count, not the initial one. Shapes
    stay static per bucket (log2-bounded recompiles instead of the reference's
    every-step realloc). Order of survivors is preserved, so physics
    accumulators are unchanged up to tile-boundary f32 regrouping. Returns the
    input unchanged if no smaller bucket fits. Host-side; the np.asarray
    reads gather sharded states to host (the driver re-pads + re-shards the
    compacted result when shards > 1).
    """
    mass = np.asarray(state.mass)
    alive_idx = np.flatnonzero(mass > 0)
    n_alive = max(1, len(alive_idx))
    new_cap = max(min_capacity,
                  1 << int(np.ceil(np.log2(n_alive * slack))))
    if new_cap >= state.capacity:
        return state
    take = alive_idx[:new_cap]

    def gather(x):
        x = np.asarray(x)
        out = np.zeros((new_cap,) + x.shape[1:], x.dtype)
        out[:len(take)] = x[take]
        return out

    return make_state(gather(state.pos), gather(state.vel),
                      gather(state.mass), gather(state.radius),
                      step=int(np.asarray(state.step)),
                      sim_time=float(np.asarray(state.sim_time)))
