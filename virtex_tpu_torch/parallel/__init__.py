from virtex_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    replicate_,
    shard_batch,
)

__all__ = ["Mesh", "create_mesh", "replicate_", "shard_batch"]
