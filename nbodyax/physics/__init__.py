"""Physics: force/collision/integration.

- ``pairwise``  — dense jnp all-pairs accumulators (reference-semantics oracle).
- ``collisions``— merge/bounce resolution modes (reference | momentum | elastic).
- ``step``      — full step composition (forces -> collisions -> boundary ->
                  integrate), the analog of ComputeForces + MoveBodies
                  (/root/reference/src/nbody.cu:139-292).
- ``kernels``   — Pallas GPU tiled all-pairs kernel (single-device hot path).
"""

from nbodyax.physics.step import make_step, PhysicsParams  # noqa: F401
