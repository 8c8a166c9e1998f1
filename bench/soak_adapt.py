"""bhAdapt soak under sustained collapse/merging.

Run on the GPU: ``python -m bench.soak_adapt [--n 1048576]
[--steps 300]``. A merging galaxy run with ``bhAdapt`` active and all bh
knobs auto: collisions grow radii and collapse the density, driving the
state out of the startup (levels, K) envelope so the driver's between-window
self-tuning must fire repeatedly. Asserts and records:

- at least 2 adaptations (the self-tuning actually engaged);
- adaptation count stays bounded (< 12 over the run — each one costs a
  recompile, the thing the one-shot count-aware widening exists to bound);
- once the drift settles, the final adaptation restores ``bh_overflow``
  to zero and HOLDS it (during active collapse each count-aware widening
  is exact for the state it measured, but the density can outrun it until
  the collapse ends — the trailing window is the honest exactness check);
- steps/s and the overflow/adapt trace, one JSON line.
"""

from __future__ import annotations

import argparse
import io
import json
import time
from contextlib import redirect_stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.02,
                    help="0.5 collapses half the population inside 20 "
                         "steps — violent enough to coarsen the grid into "
                         "degenerate shapes and outlive the ~2 min device "
                         "execution watchdog; 0.02 drifts over hundreds")
    args = ap.parse_args(argv)

    import tempfile
    from pathlib import Path

    from nbodyax.config import SimConfig
    from nbodyax.driver import run_simulation

    tmp = Path(tempfile.mkdtemp(prefix="soak_adapt_"))
    cfg = SimConfig(
        particle_count=args.n, total_iterations=args.steps,
        scene="galaxy", force_model="bh", softening=100.0,
        # reference merging grows radii and concentrates the core over
        # hundreds of steps — the drift bhAdapt exists to absorb;
        # checkpoint + autoResume ride out device failures
        timestep=args.dt, collision_mode="reference",
        log_every=args.log_every, save_images=False,
        checkpoint_every=args.log_every * 5, auto_resume=True,
        max_retries=2, checkpoint_path=str(tmp / "ck"),
        log_path=str(tmp / "soak.jsonl")).validate()

    t0 = time.perf_counter()
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = run_simulation(cfg, quiet=False)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    adapts = [l for l in out.splitlines() if l.startswith("bh adapt")]

    logs = [json.loads(l) for l in open(tmp / "soak.jsonl")]
    ov = [(l["step"], l["bh_overflow"]) for l in logs]
    nonzero = [s for s, o in ov if o > 0]
    tail_zeros = 0
    for _, o in reversed(ov):
        if o:
            break
        tail_zeros += 1

    rec = {
        "n": args.n, "steps": args.steps,
        "alive_final": logs[-1]["alive"],
        "adaptations": len(adapts),
        "adapt_log": adapts,
        "overflow_nonzero_steps": nonzero,
        "trailing_zero_checks": tail_zeros,
        "steps_per_sec": res.steps_per_sec,
        "wall_s": round(wall, 1),
    }
    print(json.dumps(rec))
    assert len(adapts) >= 2, "collapse never forced an adaptation"
    assert len(adapts) < 12, f"unbounded recompiles: {adapts}"
    assert tail_zeros >= 3, f"exactness not restored and held: {ov}"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
