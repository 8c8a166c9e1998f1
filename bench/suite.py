"""BASELINE benchmark suite: one entry per BASELINE.json config.

Run: ``python -m bench.suite [--configs 1,2,4] [--out bench/results.json]``

| # | workload                                   | checks / metric              |
|---|--------------------------------------------|------------------------------|
| 1 | N=1k softened gravity, fixed dt            | Pallas matches jnp oracle    |
| 2 | N=16k elastic bounce                       | momentum/energy conservation |
| 3 | N=131k reference merging, long horizon     | drift vs oracle, alive decay |
| 4 | N=1M single-chip fused pass                | pairs/s/chip (the headline)  |
| 5 | N=4M galaxy collision, forceModel=bh, auto | steps/s (+ exact-kernel      |
|   | knobs (BASELINE.json workload) + 8-way     | pairs/s secondary) + ring    |
|   | ring check on a virtual mesh (subprocess)  | dryrun exit status           |

Each config reports steps/sec and pairwise interactions/sec. Steps are driven
in on-device chunks (lax.fori_loop) so host dispatch overhead doesn't
pollute small-N numbers. The config-5 ring check runs in a child process
pinned to the CPU, so the parent stays the only process on the GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial

import numpy as np


def chunked_runner(step, k: int):
    """Run k steps per dispatch inside one jit (host sees 1 call per chunk)."""
    import jax
    from jax import lax

    @jax.jit
    def run(state):
        out = lax.fori_loop(0, k, lambda i, s: step(s), state)
        return out, out.pos[0, 0] + out.mass[0]  # host-fetchable fence scalar

    return run


def _time_steps(step, state, *, steps: int, chunk: int):
    if getattr(step, "_host_loop", False):
        # split-dispatch step: already host-orchestrated; fence per step
        import jax
        state = step(state)
        jax.block_until_ready(state)
        _ = float(state.pos[0, 0])
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
            _ = float(state.pos[0, 0])
        return state, (time.perf_counter() - t0) / steps
    run = chunked_runner(step, chunk)
    state, probe = run(state)
    _ = float(probe)  # compile + warm
    done = 0
    t0 = time.perf_counter()
    while done < steps:
        state, probe = run(state)
        _ = float(probe)
        done += chunk
    dt = (time.perf_counter() - t0) / done
    return state, dt


def _build(cfg):
    from nbodyax.driver import build_step
    from nbodyax.scenes import init_scene
    return init_scene(cfg, parity=False), build_step(cfg)


def config1_oracle_match():
    """N=1k, softened: Pallas trajectory vs the jnp oracle over 100 steps."""
    import jax
    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.backends import build_accum_fn
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=1024, softening=50.0, timestep=0.2)
    p = PhysicsParams.from_config(cfg)
    state = init_scene(cfg, parity=False)
    pal = make_step(p, accum_fn=build_accum_fn("auto", p))
    orc = make_step(p)
    b = state
    run_pal = chunked_runner(pal, 100)
    a, pr = run_pal(state)       # exactly 100 steps, for the comparison
    _ = float(pr)                # (doubles as compile warmup)
    t0 = time.perf_counter()
    _, pr = run_pal(state)
    _ = float(pr)
    dt = (time.perf_counter() - t0) / 100
    # f32 noise floor: the same oracle run with the bodies permuted (a genuine
    # reordering of every f32 pair sum), unpermuted afterwards — chaotic
    # amplification affects ANY reordered f32 sum equally; "matching to
    # float32 tolerance" means staying at this noise floor (SURVEY.md §7)
    rng = np.random.RandomState(0)
    perm = rng.permutation(state.capacity)
    inv = np.argsort(perm)
    from nbodyax.state import SimState
    import jax.numpy as jnp
    c = SimState(state.pos[perm], state.vel[perm], state.mass[perm],
                 state.radius[perm], state.step)
    run_orc = chunked_runner(orc, 100)
    b, pr = run_orc(b); _ = float(pr)
    c, pr = run_orc(c); _ = float(pr)
    pa, pb = np.asarray(a.pos), np.asarray(b.pos)
    pc = np.asarray(c.pos)[inv]
    alive = np.asarray(b.mass) > 0
    span = 2.0 * cfg.field_width
    drift = float(np.abs(pa[alive] - pb[alive]).max() / span)
    floor = float(np.abs(pc[alive] - pb[alive]).max() / span)
    n = state.capacity
    return {"config": 1, "n": n, "steps_per_sec": 1 / dt,
            "pairs_per_sec": n * n / dt,
            "max_pos_drift_rel_field_100steps": drift,
            "f32_noise_floor_rel_field_100steps": floor,
            "oracle_match_f32": bool(drift < max(10 * floor, 1e-4))}


def config2_elastic_conservation():
    """N=16k elastic bounce: conservation across 50 steps."""
    from nbodyax.config import SimConfig
    from nbodyax.driver import build_step
    from nbodyax.metrics import conservation_scalars
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=16384, collision_mode="elastic",
                    softening=100.0, timestep=0.2)
    state = init_scene(cfg, parity=False)
    step = build_step(cfg)
    s0 = {k: float(v) for k, v in conservation_scalars(state).items()}
    state, dt = _time_steps(step, state, steps=50, chunk=25)
    s1 = {k: float(v) for k, v in conservation_scalars(state).items()}
    mom0 = np.hypot(s0["momentum_x"], s0["momentum_y"])
    mom1 = np.hypot(s1["momentum_x"], s1["momentum_y"])
    # momentum scale: total |m v| after the run
    mscale = abs(s1["kinetic_energy"]) ** 0.5 * s1["total_mass"] ** 0.5 + 1e-30
    n = state.capacity
    return {"config": 2, "n": n, "steps_per_sec": 1 / dt,
            "pairs_per_sec": n * n / dt,
            "mass_rel_drift": abs(s1["total_mass"] - s0["total_mass"])
                              / s0["total_mass"],
            "momentum_drift_rel": float(abs(mom1 - mom0) / mscale),
            "alive": s1["alive"]}


def config3_merging_long_horizon(steps=100):
    """N=131k reference merging: long-horizon run; merge-decision agreement vs
    the jnp oracle over the first 2 steps (the oracle is O(N^2) in plain jnp —
    exact but slow, so the cross-check window is short; full equivalence is
    covered by tests/test_kernels.py at smaller N)."""
    import jax
    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.backends import build_accum_fn
    from nbodyax.scenes import init_scene
    from nbodyax.metrics import conservation_scalars

    cfg = SimConfig(particle_count=131072, collision_mode="reference",
                    timestep=0.2)
    p = PhysicsParams.from_config(cfg)
    state = init_scene(cfg, parity=False)
    step = make_step(p, accum_fn=build_accum_fn("auto", p))
    # short oracle cross-check
    orc = make_step(p, chunk=8192)
    a = b = state
    for _ in range(2):
        a = step(a)
        b = orc(b)
    mass_a, mass_b = np.asarray(a.mass), np.asarray(b.mass)
    same_alive = float(((mass_a > 0) == (mass_b > 0)).mean())
    # long horizon
    state, dt = _time_steps(step, a, steps=steps, chunk=50)
    scal = {k: float(v) for k, v in conservation_scalars(state).items()}
    n = state.capacity
    return {"config": 3, "n": n, "steps_per_sec": 1 / dt,
            "pairs_per_sec": n * n / dt,
            "alive_after": scal["alive"],
            "oracle_alive_agreement_2steps": same_alive,
            "finite": bool(np.isfinite(np.asarray(state.pos)).all())}


def config4_million_single_chip():
    """The headline: N=1M fused pass throughput (same as bench.py)."""
    from nbodyax.config import SimConfig
    from nbodyax.driver import build_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=1_048_576, collision_mode="reference")
    state = init_scene(cfg, parity=False)
    step = build_step(cfg)
    state, dt = _time_steps(step, state, steps=2, chunk=1)
    n = state.capacity
    return {"config": 4, "n": n, "steps_per_sec": 1 / dt,
            "pairs_per_sec": n * n / dt}


def config5_galaxy_4m(steps=5):
    """BASELINE config 5 as written: the N=4M galaxy-collision scenario.

    Three measurements in one entry:
    - PRIMARY: the production engine for this scene — ``forceModel=bh`` with
      auto knobs (what the 10k-step soak runs) — steps/s + equivalent-exact
      pairs/s.
    - SECONDARY: the exact all-pairs split-dispatch step (bounded device
      executions at 4M) — true pairwise pairs/s.
    - RING: the BASELINE 8-way sharding (512k bodies/device, ppermute ring)
      run in a CPU-pinned subprocess on a virtual 8-device CPU mesh
      (``__graft_entry__.dryrun_multichip`` — one real sharded step,
      reduced N).
    """
    import os
    import subprocess
    import sys
    from nbodyax.config import SimConfig
    from nbodyax.driver import build_step
    from nbodyax.scenes import init_scene

    workload = ("N=4M sharded via ring all-gather of position tiles; "
                "galaxy-collision scenario, 10k steps")
    cfg = SimConfig(particle_count=4_194_304, scene="galaxy",
                    collision_mode="reference", softening=100.0,
                    force_model="bh")
    state = init_scene(cfg, parity=False)
    # density-aware knob resolution (what the driver always does): without
    # the state probe the clustered galaxy pays the ~n/16 worst-case
    # completion list every step
    step = build_step(cfg, state=state)
    state, dt = _time_steps(step, state, steps=steps, chunk=1)

    cfg_exact = SimConfig(particle_count=4_194_304, scene="galaxy",
                          collision_mode="reference", softening=100.0)
    state_e = init_scene(cfg_exact, parity=False)
    step_e = build_step(cfg_exact)
    state_e, dt_e = _time_steps(step_e, state_e, steps=1, chunk=1)

    t0 = time.perf_counter()
    ring = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=1800)
    ring_wall = round(time.perf_counter() - t0, 1)

    n = state.capacity
    return {"config": 5, "n": n, "workload": workload,
            "force_model": "bh", "steps_per_sec": 1 / dt,
            "equivalent_exact_pairs_per_sec": n * n / dt,
            "exact_split_steps_per_sec": 1 / dt_e,
            "exact_split_pairs_per_sec": n * n / dt_e,
            "finite": bool(np.isfinite(np.asarray(state.pos)).all()),
            "ring_dryrun_8dev_ok": ring.returncode == 0,
            "ring_dryrun_wall_s": ring_wall,
            "note": "10k-step horizon executed by bench.soak10k"}


def config6_bh_million():
    """Beyond-reference: forceModel=bh at N=1M (hierarchical far field +
    exact near-field collisions). Reported as equivalent-exact pairs/s for
    comparison with config 4."""
    from nbodyax.config import SimConfig
    from nbodyax.driver import build_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=1_048_576, collision_mode="reference",
                    force_model="bh", softening=100.0)
    state = init_scene(cfg, parity=False)
    step = build_step(cfg, state=state)   # density-aware, as the driver
    state, dt = _time_steps(step, state, steps=3, chunk=1)
    n = state.capacity
    return {"config": 6, "n": n, "steps_per_sec": 1 / dt,
            "equivalent_exact_pairs_per_sec": n * n / dt,
            "force_model": "bh",
            "finite": bool(np.isfinite(np.asarray(state.pos)).all())}


CONFIGS = {1: config1_oracle_match, 2: config2_elastic_conservation,
           3: config3_merging_long_horizon, 4: config4_million_single_chip,
           5: config5_galaxy_4m, 6: config6_bh_million}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = []
    for c in [int(x) for x in args.configs.split(",")]:
        t0 = time.perf_counter()
        r = CONFIGS[c]()
        r["bench_wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
