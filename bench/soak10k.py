"""BASELINE config 5 at full spec: N=4M galaxy collision, 10,000 steps.

The reference's endurance anchor is 16,384 bodies x 2,000 steps
(/root/reference/nbodyConfig.txt:1-2); BASELINE.md config 5 scales that to
N=4M sharded/single-chip with a 10k-step horizon. This runner executes the
horizon end-to-end on the GPU in resumable stages:

- ``--until K`` runs from the latest checkpoint (or a fresh scene) to step K
  in ONE ``run_simulation`` invocation with ``autoResume`` armed — transient
  device failures reload the newest snapshot and continue.
- Invoking the runner again with a larger ``--until`` is a REAL resume
  boundary: a fresh process, fresh jit cache, state reloaded from disk
  (exactly the crash-recovery path). Run the stages one after another —
  start the next process only after the previous one has exited, since each
  holds most of the GPU's memory while it runs: ``--until 5000`` then
  ``--until 10000``.
- Checkpoints every 100 steps with retention (keep-last-3 + every-2000-step
  milestones) so the run leaves ~0.7 GB on disk, not 10 GB.
- JSONL metrics every 50 steps (alive/mass/momentum/KE/sim-wall/bh_overflow)
  accumulate across stages in one file — the conservation trajectory.

On completion (state.step == --total) the runner summarizes the JSONL into a
single record (``--out``): step count, wall, steps/s, overflow census,
alive/mass trajectory endpoints, resume boundary count.

Run: ``python -m bench.soak10k --until 5000`` then ``--until 10000``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--until", type=int, default=10_000,
                    help="run from the latest checkpoint to this step")
    ap.add_argument("--total", type=int, default=10_000,
                    help="full horizon; the summary record is written when "
                         "the state reaches it")
    ap.add_argument("--workdir", default="/tmp/nbodyax_soak10k")
    ap.add_argument("--out", default="")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    # the galaxy collision merges ~90% of the 4M bodies inside the first
    # ~100 steps (alive 4.19M -> 0.4M measured); without compaction the bh
    # grid pays full-capacity cost for the whole horizon. 100 matches the
    # merger timescale, and the driver additionally compacts EARLY whenever
    # the live count guarantees a capacity halving (driver.py early
    # trigger), so the cadence is only the steady-state backstop.
    ap.add_argument("--compact-every", type=int, default=100)
    ap.add_argument("--partial-ok", action="store_true",
                    help="write the --out record even before the full "
                         "horizon (steps_total then reflects progress; a "
                         "later resumed invocation overwrites it)")
    args = ap.parse_args(argv)

    import numpy as np

    from nbodyax.config import SimConfig
    from nbodyax.driver import run_simulation
    from nbodyax.io.checkpoint import latest_checkpoint
    from nbodyax.metrics import conservation_scalars

    os.makedirs(args.workdir, exist_ok=True)
    ck_path = os.path.join(args.workdir, "cks")
    log_path = os.path.join(args.workdir, "soak.jsonl")
    stage_log = os.path.join(args.workdir, "stages.jsonl")

    cfg = SimConfig(
        particle_count=args.n, scene="galaxy", softening=100.0,
        collision_mode="reference", force_model="bh",
        total_iterations=args.until, save_images=False,
        log_every=args.log_every, log_path=log_path,
        checkpoint_every=args.checkpoint_every, checkpoint_path=ck_path,
        checkpoint_keep=3, checkpoint_milestone_every=2000,
        compact_every=args.compact_every,
        auto_resume=True, max_retries=5)

    ck = latest_checkpoint(ck_path)
    resumed_from = 0
    if ck is not None:
        cfg.resume_from = ck
        with np.load(ck) as z:
            resumed_from = int(z["step"])
        if resumed_from >= args.until:
            print(f"latest checkpoint already at step {resumed_from} >= "
                  f"--until {args.until}; nothing to run")
    t0 = time.perf_counter()
    if resumed_from < args.until:
        res = run_simulation(cfg, quiet=False)
        end_step = int(np.asarray(res.state.step))
        scal = {k: float(v) for k, v in
                conservation_scalars(res.state).items()}
        finite = bool(np.isfinite(np.asarray(res.state.pos)).all())
        stage = {"stage_from": resumed_from, "stage_to": end_step,
                 "wall_s": round(time.perf_counter() - t0, 1),
                 "steps_per_sec": res.steps_per_sec, "finite": finite,
                 "windows": res.windows, **scal}
        with open(stage_log, "a") as f:
            f.write(json.dumps(stage) + "\n")
        print(json.dumps(stage), flush=True)
        assert finite, "non-finite state"
        assert end_step == args.until, (end_step, args.until)
    else:
        end_step = resumed_from

    if args.out and (end_step >= args.total or args.partial_ok):
        _summarize(args, log_path, stage_log, ck_path)
    return 0


def _summarize(args, log_path, stage_log, ck_path):
    import numpy as np

    rows = [json.loads(line) for line in open(log_path)]
    stages = [json.loads(line) for line in open(stage_log)]
    # the JSONL may contain duplicate step entries when a failed attempt was
    # resumed mid-stage (autoResume); keep the LAST entry per step — the one
    # from the attempt that actually progressed
    by_step = {}
    for r in rows:
        by_step[r["step"]] = r
    steps = sorted(by_step)
    rows = [by_step[s] for s in steps]
    overflow = [r.get("bh_overflow", 0) for r in rows]
    nz = [s for s, o in zip(steps, overflow) if o]
    # persistent = two consecutive nonzero overflow logs (transient single
    # blips are healed by bhAdapt's next window; see driver.py adapt block)
    persistent = sum(1 for i in range(1, len(overflow))
                     if overflow[i] and overflow[i - 1])
    # end-to-end wall from the STAGE records when they cover the horizon
    # (they include compiles, probes, and window dispatch overhead); the
    # JSONL windows (wall_ms = the window's metered per-step device wall)
    # only estimate device time and miss everything between windows. The
    # JSONL fallback covers stages killed before writing their record.
    wall_jsonl = sum(r["wall_ms"] * args.log_every / 1000.0 for r in rows)
    covered = (stages and min(s["stage_from"] for s in stages) == 0
               and max(s["stage_to"] for s in stages) >= (steps[-1]
                                                          if steps else 0))
    wall = sum(s["wall_s"] for s in stages) if covered else wall_jsonl
    record = {
        "bench": "soak10k_config5", "n": args.n, "force_model": "bh",
        "scene": "galaxy", "steps_total": steps[-1] if steps else 0,
        "partial": bool(steps and steps[-1] < args.total),
        "horizon": args.total,
        "log_points": len(rows),
        "resume_boundaries": max(0, len(stages) - 1),
        "auto_resume_retries_visible": sum(
            1 for i in range(1, len(stages))
            if stages[i]["stage_from"] < stages[i - 1]["stage_to"]),
        "alive_first": rows[0]["alive"], "alive_last": rows[-1]["alive"],
        "alive_monotonic_nonincreasing": all(
            rows[i]["alive"] >= rows[i + 1]["alive"]
            for i in range(len(rows) - 1)),
        "total_mass_first": rows[0]["total_mass"],
        "total_mass_last": rows[-1]["total_mass"],
        "kinetic_energy_last": rows[-1]["kinetic_energy"],
        "sim_time_last": rows[-1].get("sim_time", 0.0),
        "bh_overflow_nonzero_logs": len(nz),
        "bh_overflow_persistent_pairs": persistent,
        "bh_overflow_max": max(overflow) if overflow else 0,
        "bh_overflow_last": overflow[-1] if overflow else 0,
        "finite_all_stages": all(s["finite"] for s in stages),
        "wall_s_total": round(wall, 1),
        "wall_s_device_estimate": round(wall_jsonl, 1),
        "steps_per_sec_mean": round(steps[-1] / wall, 4) if wall else 0.0,
        "checkpoints_on_disk": sorted(os.listdir(ck_path)),
    }
    print(json.dumps(record), flush=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
