"""One process of the 2-process multi-host bring-up smoke (test_multihost.py).

Spawned with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID in
the environment and 2 virtual CPU devices per process; goes through
``maybe_init_distributed`` (the DCN analog of SURVEY.md section 5's
"distributed communication backend" row), then drives ONE ring step over the
4-device GLOBAL mesh on tiny shapes — multi-controller SPMD: each process
supplies its local shards, jit runs the identical program, the ppermute hops
cross the process boundary over the coordination service.

Prints ``CHECKSUM <pos> <vel> <mass>`` (global replicated sums after the
step) for the parent to compare across processes and against its own
single-process 4-shard run of the same step.
"""

import os
import sys

import jax

# tests run on the CPU (as in tests/conftest.py)
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nbodyax.sharding.mesh import AXIS, make_mesh, maybe_init_distributed


def main() -> None:
    maybe_init_distributed()
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.local_devices()) == 2, jax.local_devices()
    assert len(jax.devices()) == 4, jax.devices()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbodyax.config import SimConfig
    from nbodyax.physics.step import PhysicsParams
    from nbodyax.sharding.ring import make_sharded_step
    from nbodyax.state import SimState

    # identical deterministic state in both processes (and in the parent)
    rng = np.random.RandomState(42)
    n = 32
    pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)

    cfg = SimConfig(particle_count=n, shards=4, field_width=1000,
                    field_height=1000, timestep=0.1,
                    save_images=False).validate()
    p = PhysicsParams.from_config(cfg)
    mesh = make_mesh(4)
    step = make_sharded_step(cfg, p, mesh)

    sh = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    mk = lambda a, s: jax.make_array_from_callback(
        a.shape, s, lambda idx: a[idx])
    state = SimState(pos=mk(pos, sh), vel=mk(vel, sh), mass=mk(mass, sh),
                     radius=mk(radius, sh),
                     step=mk(np.int32(0), rep))

    out = step(state)
    sums = jax.jit(lambda s: (s.pos.sum(), s.vel.sum(), s.mass.sum()),
                   out_shardings=(rep, rep, rep))(out)
    print("CHECKSUM", *[f"{float(v):.6e}" for v in sums], flush=True)


if __name__ == "__main__":
    main()
