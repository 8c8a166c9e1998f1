"""GPU gradient-step timing at headline scale (N=1M, backend=pallas).

Reverse-mode through a k-step rollout of the exact Pallas pair kernel
(forward pass + a backward that is the VJP of the same raw channels in
plain jnp, wired via jax.custom_vjp in physics/kernels.py), with per-step
jax.checkpoint so residual memory stays O(k * state). The reference cannot
express this at all (/root/reference/src/nbody.cu is forward-only CUDA).

Reports seconds per gradient step (wall of one jitted grad call / k) next
to the forward step for the same configuration — the grad/forward ratio is
the number to watch.

Run: ``python -m bench.grad_step [--n 1048576] [--steps 4] [--mode reference]``
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--mode", default="reference",
                    choices=("reference", "momentum", "elastic"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbodyax.autodiff import make_loss
    from nbodyax.config import SimConfig
    from nbodyax.physics.kernels import pallas_pair_accumulators
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=args.n, collision_mode=args.mode,
                    softening=100.0, save_images=False)
    p = PhysicsParams.from_config(cfg)
    state = init_scene(cfg)
    step = make_step(p, accum_fn=partial(
        pallas_pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=args.mode))

    # terminal loss: mean squared distance to the origin of the alive
    # bodies — O(1)-conditioned, every position contributes
    def terminal(s):
        w = (s.mass > 0).astype(jnp.float32)
        return jnp.sum(w * jnp.sum(s.pos * s.pos, -1)) / jnp.sum(w)

    loss = make_loss(step, args.steps, terminal)
    grad = jax.jit(jax.grad(lambda pos: loss(state._replace(pos=pos))))

    def fence(x):
        return float(jnp.sum(jnp.abs(x)))  # host fetch = completion fence

    # forward step baseline (same config/backend)
    fwd = jax.jit(step)
    s1 = fwd(state)
    fence(s1.pos)
    t0 = time.perf_counter()
    s1 = fwd(state)
    fence(s1.pos)
    t_fwd = time.perf_counter() - t0

    g = grad(state.pos)            # compile + warmup
    gsum = fence(g)
    assert np.isfinite(gsum) and gsum > 0, "zero/non-finite gradient"
    t0 = time.perf_counter()
    g = grad(state.pos)
    fence(g)
    t_grad = time.perf_counter() - t0

    rec = {
        "bench": "grad_step", "n": args.n, "steps": args.steps,
        "mode": args.mode, "backend": "pallas",
        "forward_step_s": round(t_fwd, 4),
        "grad_wall_s": round(t_grad, 4),
        "grad_step_s": round(t_grad / args.steps, 4),
        "grad_over_forward": round(t_grad / args.steps / t_fwd, 3),
        "grad_abs_sum": gsum,
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
