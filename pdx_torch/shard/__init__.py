"""pdx_torch.shard — device meshes, sharded sufficient statistics and the
multi-device dry run."""

from pdx_torch.shard.mesh import (
    Mesh,
    make_mesh,
    sharded_gram_stats,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "sharded_gram_stats", "shard_batch"]
