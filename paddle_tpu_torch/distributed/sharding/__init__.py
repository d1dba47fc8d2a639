"""GroupSharded / ZeRO of the port (after
``paddle_tpu/distributed/sharding``): ``group_sharded_parallel`` at the
levels ``os``, ``os_g`` and ``p_g_os``, ``DygraphShardingOptimizer``
(stage 1 under ``fleet``) and the placement rule
``add_sharding_axis``."""
from .group_sharded import (  # noqa: F401
    GroupShardedModel,
    add_sharding_axis,
    group_sharded_parallel,
    save_group_sharded_model,
)
from .sharding_optimizer import (  # noqa: F401
    DygraphShardingOptimizer,
    ShardedOptimizer,
    sharding_dim,
)

__all__ = [
    "group_sharded_parallel",
    "save_group_sharded_model",
    "GroupShardedModel",
    "ShardedOptimizer",
    "DygraphShardingOptimizer",
    "add_sharding_axis",
    "sharding_dim",
]
