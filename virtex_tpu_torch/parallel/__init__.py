from virtex_tpu_torch.parallel.mesh import (
    Mesh,
    check_divisible,
    create_mesh,
    gather_state_dict,
    replicate_,
    shard_batch,
    shard_module_,
    shard_state_dict,
)

__all__ = ["Mesh", "check_divisible", "create_mesh", "gather_state_dict",
           "replicate_", "shard_batch", "shard_module_", "shard_state_dict"]
