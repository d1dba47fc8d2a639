"""Distributed API of the port (after ``paddle_tpu/distributed``): the
process world, the hybrid topology and mesh, the eager collectives and
``fleet``, as far as context-parallel attention needs them."""
from .collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    p2p_exchange,
    recv,
    send,
)
from .parallel import (  # noqa: F401
    ParallelEnv,
    destroy_process_group,
    get_device,
    get_group,
    get_mesh,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    new_group,
    set_mesh,
)
from .topology import (  # noqa: F401
    HYBRID_AXES,
    CommunicateTopology,
    Group,
    HybridCommunicateGroup,
    build_mesh,
)
from . import fleet  # noqa: F401

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "all_to_all", "barrier", "send",
    "recv", "p2p_exchange", "ParallelEnv", "destroy_process_group",
    "get_device", "get_group",
    "get_mesh", "get_rank", "get_world_size", "init_parallel_env",
    "is_initialized", "new_group", "set_mesh", "HYBRID_AXES",
    "CommunicateTopology", "Group", "HybridCommunicateGroup", "build_mesh",
    "fleet",
]
