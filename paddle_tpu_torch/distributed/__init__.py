"""Distributed API of the port (after ``paddle_tpu/distributed``): the
process world and ``DataParallel``, the hybrid topology and mesh, the
eager collectives, ``fleet`` (context-parallel attention, the
tensor-parallel layers, ``distributed_model`` / ``distributed_optimizer``
and the hybrid-parallel optimizers), ``sharding`` (ZeRO stages 1-3),
checkpoints saved by one process or by every rank of a group, the
preemption machinery, and the process tail: ``launch`` (``python -m
paddle_tpu_torch.distributed.launch``), ``spawn``, ``TCPStore``, ``rpc``
and the parameter server ``ps``."""
from .collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    fcollectives,
    p2p_exchange,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from .parallel import (  # noqa: F401
    DataParallel,
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
    subgroup,
)
from .topology import (  # noqa: F401
    HYBRID_AXES,
    CommunicateTopology,
    Group,
    HybridCommunicateGroup,
    build_mesh,
)
from . import communication  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    AsyncSaveHandle,
    load_state_dict,
    save_state_dict,
    verify_contents,
)
from .ckpt_manager import (  # noqa: F401
    CheckpointManager,
    PreemptionGuard,
    TrainingPreempted,
    pack_train_state,
    unpack_train_state,
)
from .spawn import spawn  # noqa: F401
from . import launch  # noqa: F401
from . import rpc  # noqa: F401
from . import ps  # noqa: F401
from .store import TCPStore  # noqa: F401

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "all_gather_object",
    "all_to_all", "barrier", "broadcast", "reduce", "reduce_scatter",
    "scatter", "fcollectives", "send", "recv", "p2p_exchange",
    "communication", "subgroup", "DataParallel", "sharding",
    "ParallelEnv", "destroy_process_group",
    "get_device", "get_group",
    "get_mesh", "get_rank", "get_world_size", "init_parallel_env",
    "is_initialized", "new_group", "set_mesh", "HYBRID_AXES",
    "CommunicateTopology", "Group", "HybridCommunicateGroup", "build_mesh",
    "fleet", "save_state_dict", "load_state_dict", "verify_contents",
    "AsyncSaveHandle", "AsyncCheckpointer", "CheckpointManager",
    "PreemptionGuard", "TrainingPreempted", "pack_train_state",
    "unpack_train_state", "spawn", "launch", "rpc", "ps", "TCPStore",
]
