"""Device mesh setup and state sharding.

The communication backend is XLA collectives over the mesh (ppermute /
all_gather / pmin), which XLA hands to NCCL on GPUs — there is no
communicator to manage by hand (SURVEY.md section 5, "Distributed
communication backend"). Multi-host process bring-up goes through
``jax.distributed.initialize`` (guarded: single-process runs skip it).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbodyax.state import SimState

__all__ = ["make_mesh", "shard_state", "pad_to_shards", "maybe_init_distributed",
           "AXIS"]

AXIS = "shard"


def maybe_init_distributed() -> None:
    """Multi-host bring-up when launched under a JAX-aware launcher.

    Single-process (the common case, incl. tests) is a no-op. Multi-host
    launchers set JAX_COORDINATOR_ADDRESS; jax.distributed
    reads the address directly and auto-detects process count/id on managed
    clusters (SLURM, OpenMPI, GKE). Plain launchers (ssh loops, the
    2-process smoke test) have no cluster detector, so JAX_NUM_PROCESSES /
    JAX_PROCESS_ID are honored explicitly when set.
    """
    if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return
    kwargs = {}
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if nproc is not None:
        kwargs = dict(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def make_mesh(n_shards: int, devices=None) -> Mesh:
    """1-D mesh over the first n_shards devices (ring order = device order;
    the GPUs of one host are joined all to all, so the order costs
    nothing)."""
    devices = devices if devices is not None else jax.devices()
    if n_shards > len(devices):
        raise ValueError(
            f"shards={n_shards} exceeds available devices ({len(devices)})")
    return Mesh(np.array(devices[:n_shards]), (AXIS,))


def pad_to_shards(state: SimState, n_shards: int) -> SimState:
    """Pad capacity to a multiple of n_shards with dead slots (mass 0)."""
    n = state.capacity
    npad = -(-n // n_shards) * n_shards
    if npad == n:
        return state
    pad = npad - n

    def pad1(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    return SimState(pos=pad1(state.pos), vel=pad1(state.vel),
                    mass=pad1(state.mass), radius=pad1(state.radius),
                    step=state.step, sim_time=state.sim_time)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place body arrays with NamedSharding over the shard axis (step scalar
    replicated)."""
    sh = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    return SimState(pos=jax.device_put(state.pos, sh),
                    vel=jax.device_put(state.vel, sh),
                    mass=jax.device_put(state.mass, sh),
                    radius=jax.device_put(state.radius, sh),
                    step=jax.device_put(state.step, rep),
                    sim_time=jax.device_put(
                        jnp.asarray(state.sim_time, jnp.float32), rep))
