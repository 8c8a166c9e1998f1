"""Multi-device scaling: mesh setup + ppermute ring all-gather.

The reference is single-GPU/single-process (SURVEY.md section 2.2); this
package provides the scale-out the north star requires: bodies sharded over a
``jax.sharding.Mesh`` axis, with remote body tiles circulating around a
ring via ``lax.ppermute`` so every shard sees all N bodies each step — the
distributed generalization of the reference's rotating shared-memory tile
schedule (/root/reference/src/nbody.cu:186).
"""

from nbodyax.sharding.mesh import make_mesh, shard_state, pad_to_shards  # noqa: F401
from nbodyax.sharding.ring import make_sharded_step, ring_accumulators  # noqa: F401
from nbodyax.sharding.bh import make_sharded_bh_step  # noqa: F401
