"""Fleet facade (after ``paddle_tpu/distributed/fleet``): ``fleet.init``
with a ``DistributedStrategy``, the hybrid topology it builds, the
context-parallel attention of ``meta_parallel``, and ``recompute``."""
from __future__ import annotations

from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (  # noqa: F401
    distributed_model,
    distributed_optimizer,
    fleet_state,
    get_hybrid_communicate_group,
    hybrid_degrees,
    init,
    is_first_worker,
    worker_index,
    worker_num,
)
from . import meta_parallel  # noqa: F401
from . import recompute as recompute_mod  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
