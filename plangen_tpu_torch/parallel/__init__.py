from plangen_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    init_distributed,
    param_placement,
    param_shardings,
    shard_params,
)

__all__ = ["create_mesh", "param_placement", "param_shardings", "batch_sharding",
           "shard_params", "init_distributed"]
