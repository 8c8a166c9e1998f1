"""Component timing for the bh force model at N=1M (what dominates a step).

Run on the GPU: ``python -m bench.bh_profile [--n 1048576]``. Times the far
field, the near field, the full accumulator pass, and the full step
separately (each jitted and fenced with a host scalar fetch). One JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--levels", type=int, default=0)
    ap.add_argument("--k", type=int, default=32,
                    help="near row cap (0 = auto_neighbor_k)")
    ap.add_argument("--ring", type=int, default=1)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--cicap", type=int, default=0,
                    help="per-cell slot cap override (0 = slot_cap auto)")
    ap.add_argument("--far", default="fmm", choices=("fmm", "direct"))
    ap.add_argument("--near", default="rows", choices=("rows", "slots"))
    ap.add_argument("--only", default="",
                    help="comma-separated probe names (default: all)")
    ap.add_argument("--scene", default="uniform",
                    choices=("uniform", "galaxy"),
                    help="scene to profile (galaxy = BASELINE config-5 disks)")
    ap.add_argument("--compcap", type=int, default=0,
                    help="bhCompCap completion-budget override (0 = default)")
    ap.add_argument("--giants", type=int, default=1024,
                    help="bhGiants exact-collision list size (0 = off; at "
                         "N=16M the pass's full-length accumulator "
                         "temporaries exceed the 16 GB chip — r5)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from nbodyax.config import SimConfig
    from nbodyax.driver import build_step
    from nbodyax.physics.barneshut import (_extent, _far_force, _near_field,
                                           auto_levels, bh_accumulators,
                                           slot_cap)
    from nbodyax.scenes import init_scene

    n = args.n
    levels = args.levels or auto_levels(n, dim=args.dim)
    if not args.k:
        from nbodyax.physics.barneshut import auto_neighbor_k
        args.k = auto_neighbor_k(n, levels, args.ring, args.dim, args.near)
    cfg = SimConfig(particle_count=n, collision_mode="reference",
                    force_model="bh", softening=100.0, bh_levels=levels,
                    bh_neighbor_k=args.k, bh_ring=args.ring,
                    bh_order=args.order, dimensions=args.dim,
                    bh_far=args.far, bh_near=args.near,
                    scene=args.scene,
                    bh_giants=args.giants,
                    bh_comp_cap=args.compcap)
    state = init_scene(cfg, parity=False)
    pos, vel = state.pos, state.vel
    mass, radius = state.mass, state.radius
    eps2 = jnp.float32(cfg.softening) ** 2
    ids = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def far_only(pos, mass):
        ext = _extent(pos, mass > 0)
        f = _far_force(pos, pos, mass, ext, levels, args.ring, eps2, 8192,
                       args.order)
        return f[0, 0] + f[-1, 1]

    @jax.jit
    def near_only(pos, vel, mass, radius):
        ext = _extent(pos, mass > 0)
        acc = _near_field(pos, vel, mass, radius, ids, pos, vel, mass, radius,
                          ext, levels, args.ring, eps2, jnp.float32(0.1),
                          "reference", args.k, 8192)
        return acc.force[0, 0] + acc.gained_mass[-1]

    @jax.jit
    def accum_full(pos, vel, mass, radius):
        acc = bh_accumulators(pos, vel, mass, radius, eps=cfg.softening,
                              growth_rate=0.1, mode="reference", levels=levels,
                              ring=args.ring, neighbor_k=args.k,
                              order=args.order, ci_cap=args.cicap,
                              far=args.far, near=args.near,
                              comp_cap=args.compcap)
        return acc.force[0, 0] + acc.gained_mass[-1]

    step = build_step(cfg)

    def timed(fn, *a):
        r = fn(*a)
        _ = float(r if not hasattr(r, "pos") else r.pos[0, 0])  # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            r = fn(*a)
            _ = float(r if not hasattr(r, "pos") else r.pos[0, 0])
        return (time.perf_counter() - t0) / args.reps

    from nbodyax.physics.barneshut import (_far_force_cells, _level_grids,
                                           _near_field_cells,
                                           _partner_structure)

    g = 1 << levels
    cap = args.cicap or slot_cap(n, g ** args.dim)

    @jax.jit
    def structure_only(pos, vel, mass, radius):
        ext = _extent(pos, mass > 0)
        s = _partner_structure(pos, vel, mass, radius, ext, g, False)
        return s[0][0] + s[2][0] + s[4][0, 0]

    @jax.jit
    def sort_only(pos, mass):
        # just the partner structure's stable (cell, iota) sort
        from jax import lax

        from nbodyax.physics.barneshut import _cells, _flatten_cells
        ext = _extent(pos, mass > 0)
        cell = jnp.where(mass > 0,
                         _flatten_cells(_cells(pos, ext, g), g),
                         g ** args.dim)
        s_cell, order = lax.sort(
            (cell, jnp.arange(n, dtype=jnp.int32)), num_keys=1,
            is_stable=True)
        return s_cell[0] + order[-1]

    @jax.jit
    def grids_only(pos, mass):
        ext = _extent(pos, mass > 0)
        grids = _level_grids(pos, mass, ext, levels, args.order)
        return sum(gr[0][0] for gr in grids.values())

    @jax.jit
    def near_cells_only(pos, vel, mass, radius):
        ext = _extent(pos, mass > 0)
        acc = _near_field_cells(pos, vel, mass, radius, ext, levels,
                                args.ring, eps2, jnp.float32(0.1),
                                "reference", args.k, ci_cap=cap,
                                near=args.near, comp_cap=args.compcap)
        return acc.force[0, 0] + acc.gained_mass[-1]

    @jax.jit
    def fmm_far_only(pos, mass):
        from nbodyax.physics.barneshut import _fmm_far_force
        ext = _extent(pos, mass > 0)
        f = _fmm_far_force(pos, mass, ext, levels, args.ring + 1, eps2,
                           args.order)
        return f[0, 0] + f[-1, 1]

    @jax.jit
    def annulus_only(pos, vel, mass, radius):
        from nbodyax.physics.barneshut import (_annulus_force_cells,
                                               _level_grids)
        ext = _extent(pos, mass > 0)
        s = _partner_structure(pos, vel, mass, radius, ext, g, False)
        grids = _level_grids(pos, mass, ext, levels, order=2)
        fs, si = _annulus_force_cells(jnp.stack(grids[levels], axis=1), ext,
                                      levels, args.ring, args.ring + 1, eps2,
                                      2, s, ci_cap=cap)
        return fs[0, 0] + si[-1]

    @jax.jit
    def far_cells_only(pos, vel, mass, radius):
        ext = _extent(pos, mass > 0)
        s = _partner_structure(pos, vel, mass, radius, ext, g, False)
        fs, si = _far_force_cells(pos, mass, ext, levels, args.ring, eps2,
                                  args.order, s, ci_cap=cap)
        return fs[0, 0] + si[-1]

    probes = {
        "structure_s": (structure_only, (pos, vel, mass, radius)),
        "sort_s": (sort_only, (pos, mass)),
        "grids_s": (grids_only, (pos, mass)),
        "near_cells_s": (near_cells_only, (pos, vel, mass, radius)),
        "far_cells_s": (far_cells_only, (pos, vel, mass, radius)),
        "fmm_far_s": (fmm_far_only, (pos, mass)),
        "annulus_s": (annulus_only, (pos, vel, mass, radius)),
        "far_s": (far_only, (pos, mass)),
        "near_s": (near_only, (pos, vel, mass, radius)),
        "accum_s": (accum_full, (pos, vel, mass, radius)),
        "full_step_s": (step, (state,)),
    }
    only = [s for s in (args.only or "").split(",") if s]
    out = {"n": n, "levels": levels, "k": args.k, "ring": args.ring,
           "order": args.order, "dim": args.dim, "ci_cap": cap,
           "far": args.far, "near": args.near,
           "scene": args.scene}
    for name, (fn, a) in probes.items():
        if only and name not in only:
            continue
        out[name] = round(timed(fn, *a), 3)
        print(json.dumps({name: out[name]}), flush=True)  # survive timeouts
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
