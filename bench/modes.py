"""Per-collision-mode throughput at N=1M.

Run on the GPU: ``python -m bench.modes [--n 1048576] [--reps 2]
[--modes reference,momentum,elastic,none]``. One JSON line per mode.

Timing is over the FULL jitted step with a host scalar fetch as the fence.
"""

from __future__ import annotations

import argparse
import json
import time


def run_mode(mode: str, n: int, reps: int, tiles=None) -> dict:
    import jax

    from nbodyax.backends import build_accum_fn
    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=n, collision_mode=mode, backend="auto",
                    softening=100.0 if mode == "elastic" else 0.0)
    p = PhysicsParams.from_config(cfg)
    if tiles:
        from functools import partial
        from nbodyax.physics.kernels import pallas_pair_accumulators
        accum = partial(pallas_pair_accumulators, eps=p.eps,
                        growth_rate=p.growth_rate, mode=mode,
                        tile_i=tiles[0], tile_j=tiles[1])
    else:
        accum = build_accum_fn(cfg.backend, p)
    step_inner = make_step(p, accum_fn=accum)

    @jax.jit
    def step_probe(state):
        out = step_inner(state)
        return out, out.pos[0, 0] + out.vel[0, 0] + out.mass[0]

    state = init_scene(cfg, parity=False)
    t0 = time.perf_counter()
    state, probe = step_probe(state)
    _ = float(probe)  # compile + warm
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        state, probe = step_probe(state)
        _ = float(probe)
    dt = (time.perf_counter() - t0) / reps
    return {"mode": mode, "n": n, "steps_per_sec": 1 / dt,
            "pairs_per_sec": float(n) * n / dt,
            "tiles": list(tiles) if tiles else None,
            "compile_s": round(compile_s, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--modes", default="reference,momentum,elastic")
    ap.add_argument("--tiles", default="",
                    help="comma list of TIxTJ variants, e.g. 1024x2048,512x4096")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    tile_list = ([tuple(int(v) for v in t.split("x"))
                  for t in args.tiles.split(",")] if args.tiles else [None])
    results = []
    for mode in args.modes.split(","):
        for tiles in tile_list:
            try:
                r = run_mode(mode, args.n, args.reps, tiles)
            except Exception as e:  # keep sweeping past a bad variant
                r = {"mode": mode, "tiles": list(tiles) if tiles else None,
                     "error": f"{type(e).__name__}: {str(e)[:200]}"}
            print(json.dumps(r), flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
