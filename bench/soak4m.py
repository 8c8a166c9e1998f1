"""4M-body checkpointed soak at full BASELINE scale (single chip).

Runs the N=4M galaxy scene through the split-dispatch step for a multi-step
horizon WITH a real resume boundary: phase A runs ``steps_a`` iterations and
checkpoints, phase B resumes from the latest checkpoint (a fresh driver
invocation, exactly the crash-recovery path) and continues to
``steps_a + steps_b``. Records finiteness + conservation scalars before/after
the boundary.

Run: ``python -m bench.soak4m [--steps-a 12] [--steps-b 8] [--out ...]``
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-a", type=int, default=12)
    ap.add_argument("--steps-b", type=int, default=8)
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--workdir", default="/tmp/nbodyax_soak4m")
    ap.add_argument("--out", default="")
    ap.add_argument("--force-model", default="exact",
                    choices=("exact", "bh"),
                    help="bh runs the same soak ~30x faster (longer "
                         "horizons become practical)")
    ap.add_argument("--bh-levels", type=int, default=9)
    args = ap.parse_args(argv)

    import numpy as np

    from nbodyax.config import SimConfig
    from nbodyax.driver import run_simulation
    from nbodyax.io.checkpoint import latest_checkpoint
    from nbodyax.metrics import conservation_scalars

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir, exist_ok=True)
    ck_path = os.path.join(args.workdir, "cks")

    def cfg(total):
        return SimConfig(
            particle_count=args.n, scene="galaxy", softening=100.0,
            collision_mode="reference", total_iterations=total,
            checkpoint_every=4, log_every=4, save_images=False,
            checkpoint_path=ck_path,
            force_model=args.force_model,
            bh_levels=args.bh_levels if args.force_model == "bh" else 0,
            log_path=os.path.join(args.workdir, "soak.jsonl"))

    def scal(state):
        s = {k: float(v) for k, v in conservation_scalars(state).items()}
        s["finite"] = bool(np.isfinite(np.asarray(state.pos)).all())
        return s

    t0 = time.perf_counter()
    res_a = run_simulation(cfg(args.steps_a), quiet=False)
    a = scal(res_a.state)
    assert a["finite"], "phase A produced non-finite state"

    ck = latest_checkpoint(ck_path)
    assert ck, "no checkpoint written in phase A"
    cfg_b = cfg(args.steps_a + args.steps_b)
    cfg_b.resume_from = ck
    res_b = run_simulation(cfg_b, quiet=False)
    b = scal(res_b.state)
    total_steps = int(np.asarray(res_b.state.step))

    record = {
        "bench": "soak4m", "n": args.n, "force_model": args.force_model,
        "steps_total": total_steps,
        "resume_boundary_at": args.steps_a,
        "phase_a": a, "phase_b": b,
        "pairs_per_sec_phase_b": res_b.pairs_per_sec,
        "steps_per_sec_phase_b": res_b.steps_per_sec,
        "alive_monotonic_nonincreasing": b["alive"] <= a["alive"],
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    assert b["finite"], "phase B produced non-finite state"
    assert total_steps == args.steps_a + args.steps_b
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
