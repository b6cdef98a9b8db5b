"""Multi-device scale-out over a jax.sharding.Mesh (NCCL collectives on GPU)."""

from pano360.parallel.mesh import (  # noqa: F401
    make_mesh, sharded_extract, sharded_pair_match, distributed_lm_stats,
    distributed_step,
)
