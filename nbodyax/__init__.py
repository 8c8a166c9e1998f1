"""nbodyax — n-body simulation with collisions in JAX.

A brand-new JAX / XLA / Pallas / pjit simulation engine with the capabilities of
the CUDA assignment ``Aidan900/ppa-nbody-collisions`` (see SURVEY.md):

- O(N^2) all-pairs gravity with radius-overlap collision handling
  (reference-faithful absorb-on-contact merging, plus momentum-conserving and
  elastic modes), fused into a single tiled Pallas pass on the GPU.
- Semi-implicit Euler (reference semantics) and leapfrog integrators with
  reflective field boundaries.
- Deterministic scene generation bit-compatible with the reference's seeded
  xorshift RNG (``jbutil::randgen``) and its ``nbodyConfig.txt`` config format.
- PGM (P5) frame rendering with the reference's pixel mapping.
- Multi-chip scaling: bodies sharded over a ``jax.sharding.Mesh``; position
  tiles circulate via a ``lax.ppermute`` ring all-gather inside ``shard_map``.

Layer map (mirrors SURVEY.md section 7):

- ``config``   — ConfigData + exact nbodyConfig.txt parser.
- ``rng``      — bit-exact port of jbutil::randgen + fast native path.
- ``state``    — SimState pytree; ``scenes`` — scene constructors.
- ``physics``  — reference oracle, collision modes, integrators, Pallas kernels.
- ``sharding`` — mesh setup + ring all-gather step.
- ``render``   — rasterizer + P5 writer.
- ``io``       — checkpoint/resume.
- ``metrics``  — conservation scalars, throughput meters, JSONL logging.
- ``autodiff`` — differentiable rollouts (jax.grad through full steps;
  no reference analog — the CUDA step is forward-only).
- ``cli``      — end-to-end driver (the analog of the reference's main(),
  /root/reference/src/nbody.cu:373-551).
"""

__version__ = "0.1.0"

from nbodyax.config import SimConfig, parse_config_file  # noqa: F401
from nbodyax.state import SimState  # noqa: F401


def run_simulation(*args, **kwargs):
    """Lazy re-export of nbodyax.driver.run_simulation (imports JAX)."""
    from nbodyax.driver import run_simulation as _run
    return _run(*args, **kwargs)


def rollout(*args, **kwargs):
    """Lazy re-export of nbodyax.autodiff.rollout (imports JAX)."""
    from nbodyax.autodiff import rollout as _ro
    return _ro(*args, **kwargs)


def make_loss(*args, **kwargs):
    """Lazy re-export of nbodyax.autodiff.make_loss (imports JAX)."""
    from nbodyax.autodiff import make_loss as _ml
    return _ml(*args, **kwargs)
