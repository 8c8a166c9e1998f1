"""Differentiable-simulation demo: steer a body onto a target with jax.grad.

Optimizes body 0's initial velocity so that after a 40-step rollout (full
physics: gravity from 63 other bodies + collision handling) it arrives at a
target point — the classic "shooting" adjoint problem, solved by descending
the jitted gradient of the terminal miss distance through the whole
simulation (nbodyax.autodiff.rollout). Runs anywhere (CPU is fine at this
size): ``python examples/shooting_gradient.py``.

The reference cannot express this at all — its CUDA step is forward-only;
here reverse-mode AD falls out of the functional step design.
"""

import jax
import jax.numpy as jnp
import numpy as np

from nbodyax.autodiff import rollout
from nbodyax.backends import build_accum_fn
from nbodyax.config import SimConfig
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.state import make_state

N, SCALE, STEPS = 64, 100.0, 40
TARGET = jnp.asarray([75.0, -60.0])


def build_problem(n: int = N, backend: str = "jnp"):
    """(miss, v0): the terminal miss distance as a function of body 0's
    initial velocity, for an n-body scene, with the pair pass of
    ``backend`` (backends.build_accum_fn)."""
    rng = np.random.RandomState(7)
    state = make_state(
        rng.uniform(-SCALE, SCALE, (n, 2)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
        rng.uniform(0.5e12, 2e12, n).astype(np.float32),   # G*m ~ 1e2
        rng.uniform(0.5, 2.0, n).astype(np.float32))

    cfg = SimConfig(particle_count=n, collision_mode="reference",
                    backend=backend, softening=5.0,
                    field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(cfg.backend, p))

    def miss(v0):
        s0 = state._replace(vel=state.vel.at[0].set(v0))
        final, _ = rollout(step, s0, STEPS)
        return jnp.sum(((final.pos[0] - TARGET) / SCALE) ** 2)

    return miss, state.vel[0]


def main():
    miss, v0 = build_problem()
    vg = jax.jit(jax.value_and_grad(miss))
    val, g = vg(v0)
    print(f"iter  0: miss^2 = {float(val):.6f}")
    for it in range(1, 21):
        # curvature ~ (STEPS*dt/SCALE)^2 = 6.4e-3 => lr well under ~150
        v0 = v0 - 30.0 * g
        val, g = vg(v0)
        if it % 4 == 0 or it == 20:
            print(f"iter {it:2d}: miss^2 = {float(val):.6f}")
    print(f"optimized initial velocity for body 0: {np.asarray(v0)}")


if __name__ == "__main__":
    main()
