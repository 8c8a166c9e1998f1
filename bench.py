"""Headline benchmark: pairwise interactions/sec on one GPU at N=1M,
collisions on.

BASELINE config 4: the exact all-pairs pass (``backend=auto``) with the
fused reference-mode collision pass. The throughput is measured over the
FULL jitted step (pair pass + collision commit + boundary + integration),
not just the kernel, timed with the host clock around
``block_until_ready``. Fails unless the default device is a GPU. Prints ONE
JSON line, with the device it ran on.
"""

import json
import sys
import time

N = 1_048_576
REPS = 2


def _run(n: int, reps: int) -> float:
    import jax

    from nbodyax.backends import build_accum_fn
    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams, make_step
    from nbodyax.scenes import init_scene

    cfg = SimConfig(particle_count=n, collision_mode="reference",
                    backend="auto")
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(cfg.backend, p))
    state = jax.block_until_ready(step(init_scene(cfg, parity=False)))

    t0 = time.perf_counter()
    for _ in range(reps):
        state = step(state)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / reps
    return float(n) * float(n) / dt


def main() -> int:
    import jax

    from nbodyax.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: the default device is {dev.platform}",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": f"pairwise_interactions_per_sec_collisions_on_N{N}",
        "value": _run(N, REPS),
        "unit": "pairs/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
