"""3-D mode benchmark: full-step pairwise throughput at N with dimensions=3.

Runs the dim=3 Pallas kernel compiled for the GPU (the CPU tests run it in
interpret mode only) and records its cost relative to 2-D. Per pair, 3-D
adds ~8 f32 ops (one more diff/square/fma chain in distance, force, and —
per mode — impulse math), so the expected ratio on a kernel bound by the
f32 pipe is roughly (ops_2d + 8) / ops_2d.

Usage: python -m bench.dim3 [--n 1048576] [--reps 1] [--mode reference]
"""

import argparse
import json
import time


def run(n: int, reps: int, mode: str, dims: int,
        force_model: str = "exact") -> float:
    import jax

    from nbodyax.backends import build_accum_fn
    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=n, collision_mode=mode, backend="auto",
                    dimensions=dims, force_model=force_model,
                    softening=50.0 if force_model == "bh" else 0.0)
    if force_model == "bh":
        from nbodyax.physics.barneshut import auto_levels
        cfg.bh_levels = auto_levels(n, dim=dims)
    p = PhysicsParams.from_config(cfg)
    step_inner = make_step(p, accum_fn=build_accum_fn(cfg.backend, p, cfg))

    @jax.jit
    def step_probe(state):
        out = step_inner(state)
        return out, out.pos[0, 0] + out.vel[0, 0] + out.mass[0]

    state = init_scene(cfg, parity=False)
    state, probe = step_probe(state)
    _ = float(probe)  # compile + fence

    t0 = time.perf_counter()
    for _ in range(reps):
        state, probe = step_probe(state)
        _ = float(probe)
    dt = (time.perf_counter() - t0) / reps
    return float(n) * float(n) / dt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--mode", default="reference")
    ap.add_argument("--force-model", default="exact", choices=["exact", "bh"])
    ap.add_argument("--also-2d", action="store_true",
                    help="measure the 2-D kernel too for the ratio")
    args = ap.parse_args()
    out = {"n": args.n, "mode": args.mode, "force_model": args.force_model,
           "pairs_per_sec_3d": run(args.n, args.reps, args.mode, 3,
                                   args.force_model)}
    if args.also_2d:
        out["pairs_per_sec_2d"] = run(args.n, args.reps, args.mode, 2,
                                      args.force_model)
        out["ratio_3d_over_2d"] = (out["pairs_per_sec_3d"]
                                   / out["pairs_per_sec_2d"])
    if args.force_model == "bh":
        out["note"] = "equivalent pairs/s (bh does O(N*levels) work)"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
