"""Interleaved A/B of the two bh near-field engines on one scene.

Run on the GPU:
``python -m bench.near_ab [uniform|galaxy] [reps] [dim] [n]``.
Both engines compile first, then reps alternate rows/slots so run-to-run
drift cancels out of the comparison. Auto knobs
(pick_levels refines the grid for rows on clustered scenes; slots absorbs
the clustering at the coarse grid via per-cell partner caps)."""
import json
import sys
import time

from nbodyax.config import SimConfig
from nbodyax.driver import build_step
from nbodyax.scenes import init_scene

scene = sys.argv[1] if len(sys.argv) > 1 else "uniform"
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
dim = int(sys.argv[3]) if len(sys.argv) > 3 else 2
n = int(sys.argv[4]) if len(sys.argv) > 4 else 1_048_576
cfg0 = SimConfig(particle_count=n, collision_mode="reference",
                 force_model="bh", softening=100.0, scene=scene,
                 dimensions=dim)
state = init_scene(cfg0, parity=False)
steps = {}
import dataclasses
for near in ("rows", "slots"):
    cfg = dataclasses.replace(cfg0, bh_near=near)
    steps[near] = build_step(cfg, state=state)
    s = steps[near](state)
    _ = float(s.pos[0, 0])  # compile + fence
    print(json.dumps({"compiled": near}), flush=True)
t = {"rows": 0.0, "slots": 0.0}
for r in range(reps):
    for near in ("rows", "slots"):
        t0 = time.perf_counter()
        s = steps[near](state)
        _ = float(s.pos[0, 0])
        t[near] += time.perf_counter() - t0
out = {"scene": scene, "reps": reps, "dim": dim, "n": n,
       **{k + "_step_s": round(v / reps, 4) for k, v in t.items()}}
print(json.dumps(out), flush=True)
