"""Differentiable simulation: reverse-mode gradients through n-body rollouts.

A capability the reference cannot express at all (a CUDA kernel has no
autodiff; /root/reference/src/nbody.cu is forward-only) but that falls out
of this framework's functional design: every step built by
``physics.step.make_step`` over the ``backend="jnp"`` accumulators is a pure
JAX function of the SimState pytree, so ``jax.grad`` flows through gravity,
collision bookkeeping, boundary handling and the integrator. That enables
adjoint workflows — initial-condition optimization ("shooting" a body onto a
target), sensitivity analysis of merge outcomes to initial masses, fitting
scene parameters to an observed trajectory.

Design notes (JAX specifics):

- The driver's hot loops use ``lax.fori_loop``, which is forward-only; a
  differentiable rollout must use ``lax.scan`` (this module's ``rollout``).
- Reverse-mode through k steps stores each step's residuals. A step's
  dominant intermediates are the O(N^2)-shaped (chunked) pair temporaries —
  storing those for every step would fill device memory long before k gets
  interesting, so ``rollout`` wraps the step in ``jax.checkpoint`` by
  default: the backward pass rematerializes each step's pair pass from its
  carried SimState, making residual memory O(k * state) instead of
  O(k * pair intermediates) — the standard trade of FLOPs for memory.
- Both all-pairs backends differentiate: the ``jnp`` oracle natively, and
  ``backend="pallas"`` through a ``jax.custom_vjp`` whose backward is the
  VJP of the same raw channels computed in plain jnp (kernels.py) —
  gradients are pinned equal between the two in every collision mode
  (tests/test_autodiff.py), including through the sharded ring.
  ``forceModel=bh`` steps remain forward-only (the tree build is
  combinatorial); use the exact kernel for adjoint work.
- Gradients are defined almost everywhere: collision masks, boundary flips
  and merge winner selection are step functions of the state, so their
  contribution to the derivative is zero (the events themselves don't
  differentiate) while the smooth gravity/integration path carries the
  signal. At an event threshold itself the derivative is one-sided, exactly
  as in any differentiable physics engine with contact.
- Everything here is f32; finite-difference checks against these gradients
  must use O(1)-conditioned losses (see tests/test_autodiff.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from nbodyax.state import SimState

__all__ = ["rollout", "make_loss"]


def rollout(step_fn: Callable[[SimState], SimState], state: SimState,
            steps: int, *, remat: bool = True,
            save_positions: bool = False
            ) -> Tuple[SimState, Optional[jax.Array]]:
    """Run ``steps`` simulation steps differentiably.

    step_fn: a ``make_step(...)`` product over the jnp backend (see module
    docstring for why Pallas-backed steps are not reverse-differentiable).
    remat: wrap each step in ``jax.checkpoint`` so the backward pass
    rematerializes pair passes instead of storing them (default True; turn
    off only for tiny N/steps where the residuals fit comfortably).
    save_positions: also return the f32[steps, N, D] position history (the
    scan's stacked outputs) for trajectory-matching losses.

    Returns ``(final_state, positions_or_None)``. Differentiable w.r.t. any
    leaf of ``state`` (and through ``step_fn``'s closed-over parameters if
    they are traced).
    """
    f = jax.checkpoint(step_fn) if remat else step_fn

    if save_positions:
        def body(s, _):
            s2 = f(s)
            return s2, s2.pos

        final, traj = lax.scan(body, state, None, length=steps)
        return final, traj

    def body(s, _):
        return f(s), None

    final, _ = lax.scan(body, state, None, length=steps)
    return final, None


def make_loss(step_fn: Callable[[SimState], SimState], steps: int,
              terminal_fn: Callable[[SimState], jax.Array], *,
              remat: bool = True) -> Callable[[SimState], jax.Array]:
    """Scalar loss ``terminal_fn(rollout(state))`` — the common adjoint shape.

    ``jax.grad`` of the returned function w.r.t. (parts of) the initial
    state gives the sensitivity of the terminal quantity; jit it for real
    sizes. terminal_fn must reduce to a scalar (e.g. squared distance of a
    body to a target at the horizon).
    """

    def loss(state: SimState) -> jax.Array:
        final, _ = rollout(step_fn, state, steps, remat=remat)
        return terminal_fn(final)

    return loss
