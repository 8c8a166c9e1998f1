"""Backend selection: which all-pairs engine computes the accumulators.

- ``jnp``    — chunked dense pass (physics/pairwise.py). Runs anywhere; the
               oracle. Default where the default backend is not a GPU.
- ``pallas`` — fused Pallas kernel for the GPU (physics/kernels.py). Default
               on a GPU.
- sharded    — when shards > 1, the per-shard engine above is wrapped in the
               ppermute ring (sharding/ring.py) by the driver.
"""

from __future__ import annotations

from functools import partial

import jax

from nbodyax.physics.pairwise import pair_accumulators
from nbodyax.physics.step import PhysicsParams


def resolve_backend(name: str) -> str:
    if name == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "jnp"
    return name


def _resolve_near(cfg) -> str:
    """bhNear for an accum fn: "auto" means the caller never probed the
    density (driver.resolve_bh_config does that against the starting state
    before reaching here) — fall back to the size crossover: rows below
    barneshut's _SLOTS_PREFERRED_N bodies, slots above (the rows engine's
    window gathers scale worse with table size)."""
    near = getattr(cfg, "bh_near", "rows")
    if near != "auto":
        return near
    from nbodyax.physics.barneshut import _SLOTS_PREFERRED_N
    n = getattr(cfg, "particle_count", 0)
    return "slots" if n >= _SLOTS_PREFERRED_N else "rows"


def build_accum_fn(backend: str, p: PhysicsParams, cfg=None):
    """Returns accum_fn(pos, vel, mass, radius) -> PairAccumulators."""
    if cfg is not None and getattr(cfg, "force_model", "exact") == "bh":
        from nbodyax.physics.barneshut import bh_accumulators
        return partial(bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
                       mode=p.collision_mode, levels=cfg.bh_levels,
                       ring=cfg.bh_ring, neighbor_k=cfg.bh_neighbor_k,
                       order=cfg.bh_order,
                       far=getattr(cfg, "bh_far", "fmm"),
                       near=_resolve_near(cfg),
                       comp_cap=getattr(cfg, "bh_comp_cap", 0),
                       n_giants=getattr(cfg, "bh_giants", 1024))
    backend = resolve_backend(backend)
    if backend == "jnp":
        return partial(pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
                       mode=p.collision_mode)
    if backend == "pallas":
        from nbodyax.physics.kernels import pallas_pair_accumulators
        return partial(pallas_pair_accumulators, eps=p.eps,
                       growth_rate=p.growth_rate, mode=p.collision_mode)
    raise ValueError(f"unknown backend {backend!r}")
