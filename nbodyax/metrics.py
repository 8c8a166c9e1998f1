"""Metrics, conservation scalars, throughput meters, structured logging.

The reference's only instruments are one end-to-end wall clock
(/root/reference/src/nbody.cu:374,548) and hand-written FLOP annotations
(nbody.cu:181-263). Here (SURVEY.md section 5): per-step structured scalars
(alive count, total mass, momentum, energies) that double as conservation-test
inputs, an interactions/sec meter with proper ``block_until_ready`` fencing,
and JSONL logging.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial
from typing import IO, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nbodyax.physics.step import GRAV_CONSTANT
from nbodyax.state import SimState

__all__ = ["conservation_scalars", "potential_energy", "StepMeter",
           "JsonlLogger"]


@jax.jit
def _conservation_vec(state: SimState):
    alive = state.mass > 0
    m = jnp.where(alive, state.mass, 0.0)
    mom = jnp.sum(m[:, None] * state.vel, axis=0)
    ke = 0.5 * jnp.sum(m * jnp.sum(state.vel * state.vel, axis=1))
    return jnp.concatenate([jnp.stack([jnp.sum(alive).astype(jnp.float32),
                                       jnp.sum(m), ke]), mom,
                            jnp.reshape(jnp.asarray(state.sim_time,
                                                    jnp.float32), (1,))])


def scalars_from_vec(v, dim: int):
    """Unpack a fetched ``_conservation_vec`` into the log dict."""
    v = np.asarray(v, dtype=np.float64)
    out = {
        "alive": int(v[0]),
        "total_mass": v[1],
        "momentum_x": v[3],
        "momentum_y": v[4],
        "kinetic_energy": v[2],
    }
    if dim == 3:
        out["momentum_z"] = v[5]
    out["sim_time"] = v[-1]
    return out


def conservation_scalars(state: SimState):
    """Cheap per-step scalars: alive count, total mass, momentum, KE.

    One jitted dispatch and ONE host fetch for all of them (returns Python
    floats): per-field eager ops cost a full dispatch + fetch round-trip
    each, which would dominate end-to-end runs at the default per-10-step
    log cadence. (The driver goes one further and folds
    ``_conservation_vec`` into its window dispatch.) The alive count rides
    the f32 vector — exact below 2^24 live bodies, rounded (log-cosmetic
    only) beyond."""
    return scalars_from_vec(_conservation_vec(state), state.vel.shape[-1])


@partial(jax.jit, static_argnames=("eps",))
def potential_energy(state: SimState, eps: float = 0.0):
    """O(N^2) pair potential  -G * sum_{i<j} m_i m_j / sqrt(d^2 + eps^2)
    (matches the reference's m/d^2 force magnitude, nbody.cu:239).
    Chunked like the force pass; intended for every-k-step logging."""
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    chunk = max(8, min(n, (1 << 22) // max(n, 1)))
    nchunks = -(-n // chunk)
    npad = nchunks * chunk
    pos_p = jnp.pad(pos, ((0, npad - n), (0, 0)))
    mass_p = jnp.pad(mass, (0, npad - n))
    idx = jax.lax.broadcasted_iota(jnp.int32, (npad, 1), 0).squeeze(-1)
    eps2 = jnp.float32(eps) ** 2

    def one(c):
        s = c * chunk
        pi = jax.lax.dynamic_slice_in_dim(pos_p, s, chunk)
        mi = jax.lax.dynamic_slice_in_dim(mass_p, s, chunk)
        ii = jax.lax.dynamic_slice_in_dim(idx, s, chunk)
        dp = pos[None, :, :] - pi[:, None, :]
        d2 = jnp.sum(dp * dp, -1) + eps2
        valid = ((mi[:, None] > 0) & (mass[None, :] > 0)
                 & (ii[:, None] != idx[None, :n]) & (d2 > 0))
        inv = jnp.where(valid, jax.lax.rsqrt(jnp.where(valid, d2, 1.0)), 0.0)
        return jnp.sum(mi[:, None] * mass[None, :] * inv)

    total = jax.lax.map(one, jnp.arange(nchunks)).sum()
    return -0.5 * GRAV_CONSTANT * total  # each pair counted twice


class StepMeter:
    """Wall-clock + throughput meter.

    Interactions are counted like the reference's own accounting
    (SURVEY.md section 6): N_capacity^2 pairs per step — the work the all-pairs
    kernel actually performs, dead slots included (they occupy lanes). Pairs
    are accumulated per stop() at the *then-current* capacity, so driver
    compaction mid-run keeps the accounting honest.

    Fencing: stop() waits on the result with block_until_ready, so the time
    covers the device execution and not just its dispatch.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.steps = 0
        self.pairs = 0.0
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None, steps: int = 1):
        if result is not None:
            jax.block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.steps += steps
        self.pairs += steps * float(self.capacity) ** 2
        self.elapsed += dt
        return dt

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.elapsed if self.elapsed else 0.0


class JsonlLogger:
    """One JSON object per line; stdout and/or file."""

    def __init__(self, path: str = "", echo: bool = True):
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._echo = echo

    def log(self, **record):
        def scalar(v):
            if isinstance(v, (jax.Array, np.ndarray, np.generic)):
                return np.asarray(v).item()
            return v
        line = json.dumps({k: scalar(v) for k, v in record.items()})
        if self._echo:
            print(line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
