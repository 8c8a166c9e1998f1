"""Full jitted exact step on the GPU: Pallas kernel against XLA's plain pass.

``python -m bench.exact_step [--n 16384,1048576] [--tiles 8x128,...]
[--chunks 0,67108864]`` prints one JSON line per variant, each with the
device kind, the card's name and power limit, steps/s and pairs/s. Variants,
all reference mode, 2-D, on the default scene:

- ``kernel``: ``backend=pallas`` (physics/kernels.py), one line per
  ``TIxTJ`` tile in ``--tiles`` (default: the kernel's default tiles, the
  ones ``backend=auto`` runs);
- ``jnp``: ``pairwise.pair_accumulators`` with ``chunk = C // n`` for each
  ``C`` in ``--chunks`` (0 = the default rule, ``max(8, 2^22 // n)``).

An empty ``--tiles`` or ``--chunks`` skips that variant.

Each variant runs ``k`` steps per ``lax.fori_loop`` dispatch (the driver's
windowing) and is timed with the host clock around ``block_until_ready``,
after one compile-and-warm window. Fails when the default backend is not a
GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from functools import partial


def card_name_and_limit() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout.strip().splitlines()[0]


def time_step(accum_fn, n: int, *, window: int, reps: int) -> dict:
    import jax

    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=n, collision_mode="reference")
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=accum_fn)
    run = jax.jit(lambda s: jax.lax.fori_loop(0, window,
                                              lambda i, st: step(st), s))
    state = init_scene(cfg, parity=False)
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        state = jax.block_until_ready(run(state))
    dt = (time.perf_counter() - t0) / (reps * window)
    return {"n": n, "steps_per_sec": 1.0 / dt,
            "pairs_per_sec": float(n) * n / dt,
            "first_window_s": compile_s, "timed_steps": reps * window}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="16384,1048576")
    ap.add_argument("--tiles", default=None,
                    help="TIxTJ,... (default: the kernel's default tiles)")
    ap.add_argument("--chunks", default="0,67108864")
    ap.add_argument("--pair-budget", type=float, default=2e12,
                    help="pairs timed per variant (sets window x reps)")
    args = ap.parse_args(argv)

    import jax

    from nbodyax.cache import enable_compile_cache
    from nbodyax.physics import kernels
    from nbodyax.physics.pairwise import pair_accumulators

    enable_compile_cache()
    tiles = args.tiles
    if tiles is None:
        tiles = f"{kernels.DEFAULT_TILE_I}x{kernels.DEFAULT_TILE_J}"
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: default device is {dev.platform}")
    card = card_name_and_limit()
    base = {"mode": "reference", "dim": 2, "platform": dev.platform,
            "device_kind": dev.device_kind, "count": len(jax.devices()),
            "card": card}

    for n in (int(x) for x in args.n.split(",")):
        steps = max(1, int(args.pair_budget / (float(n) * n)))
        window = min(steps, 50)
        reps = max(1, steps // window)
        variants = []
        for t in filter(None, tiles.split(",")):
            ti, tj = (int(x) for x in t.split("x"))
            variants.append((
                {"variant": "kernel", "tile_i": ti, "tile_j": tj,
                 "num_warps": kernels.num_warps(ti, tj)},
                partial(kernels.pallas_pair_accumulators, eps=0.0,
                        growth_rate=0.1, mode="reference", tile_i=ti,
                        tile_j=tj)))
        for c in (int(x) for x in args.chunks.split(",") if x):
            chunk = None if c == 0 else max(8, c // n)
            variants.append((
                {"variant": "jnp", "chunk": chunk or max(8, (1 << 22) // n)},
                partial(pair_accumulators, eps=0.0, growth_rate=0.1,
                        mode="reference", chunk=chunk)))
        for tags, fn in variants:
            row = dict(base, **tags, **time_step(fn, n, window=window,
                                                  reps=reps))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
