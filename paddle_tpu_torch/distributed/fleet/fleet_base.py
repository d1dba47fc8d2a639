"""``fleet.init`` and the worker queries (after
``paddle_tpu/distributed/fleet/fleet_base.py``). ``init`` lays the world's
ranks out on the hybrid topology of the strategy's degrees, with ``dp``
inferred when it was left at 1, and builds the matching ``DeviceMesh``,
which becomes the global mesh.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..parallel import (_env, get_rank, get_world_size, init_parallel_env,
                        set_mesh)
from ..topology import (HYBRID_AXES, CommunicateTopology,
                        HybridCommunicateGroup, build_mesh)
from .base.distributed_strategy import DistributedStrategy


class _FleetState:
    def __init__(self):
        self.initialized = False
        self.strategy: Optional[DistributedStrategy] = None
        self.topology: Optional[CommunicateTopology] = None
        self.hcg: Optional[HybridCommunicateGroup] = None
        self.mesh = None


fleet_state = _FleetState()


def hybrid_degrees(configs: Dict[str, int], world_size: int) -> Dict[str, int]:
    """The degrees ``init`` uses for ``world_size`` ranks: ``configs`` with
    ``dp_degree`` inferred when it was left at 1 and the other degrees
    divide the world. Any other mismatch raises ``ValueError``."""
    hc = dict(configs)
    used = (hc["mp_degree"] * hc["pp_degree"] * hc["sharding_degree"]
            * hc["sep_degree"])
    dp = hc["dp_degree"]
    if dp * used != world_size:
        # inferred only when dp was left at its default; an explicit
        # mismatched dp_degree is a configuration error
        if dp == 1 and world_size % used == 0:
            dp = world_size // used
        else:
            raise ValueError(
                f"hybrid degrees {configs} do not match the world size "
                f"{world_size} (dp*mp*pp*sharding*sep = {dp * used})")
    hc["dp_degree"] = dp
    return hc


def init(role_maker=None, is_collective=True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         device=None):
    """Initialise the world (``device`` as :func:`init_parallel_env` takes
    it; a running world is adopted), then the topology and the mesh of the
    strategy's hybrid degrees. Every rank calls it."""
    strategy = strategy or DistributedStrategy()
    init_parallel_env(device=device)
    hc = hybrid_degrees(strategy.hybrid_configs, get_world_size())
    strategy.hybrid_configs = {"dp_degree": hc["dp_degree"]}
    dims = tuple(hc[f"{a}_degree"] for a in HYBRID_AXES)
    topo = CommunicateTopology(HYBRID_AXES, dims)
    mesh = build_mesh(*dims)
    hcg = HybridCommunicateGroup(topo, global_rank=get_rank(), mesh=mesh)

    fleet_state.initialized = True
    fleet_state.strategy = strategy
    fleet_state.topology = topo
    fleet_state.hcg = hcg
    fleet_state.mesh = mesh
    set_mesh(mesh)
    return fleet_state


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if not fleet_state.initialized:
        raise RuntimeError("call fleet.init() first")
    return fleet_state.hcg


def worker_index() -> int:
    return _env.rank


def worker_num() -> int:
    return _env.world_size


def is_first_worker() -> bool:
    return _env.rank == 0


def distributed_model(model):
    """Wrap ``model`` for the strategy's degrees, as the reference: at
    ``mp > 1`` a ``TensorParallel`` (each rank keeps its shard of every
    ``dist_spec``-annotated parameter, the replicated ones broadcast from
    the ``mp`` group's first rank); else the model itself, its parameters
    broadcast from the ``dp`` group's first rank at ``dp > 1`` so the
    replicas start equal (``distributed_optimizer``'s step averages the
    gradients over ``dp``; at ``sharding > 1`` alone the sharded optimizer
    broadcasts and reduces). A model whose parameters carry no
    ``dist_spec`` (GPT's) stays replicated. A ``PipelineLayer`` becomes a
    ``PipelineParallel``, as the reference's (its blocks' mp layers keep
    their shards; its replicated parameters are broadcast from the ``mp``
    group's first rank, and from the ``dp`` group's first rank at
    ``dp > 1``)."""
    if not fleet_state.initialized:
        raise RuntimeError("call fleet.init() first")
    topo = fleet_state.topology
    if any(c.__name__ == "PipelineLayer" for c in type(model).__mro__):
        from .meta_parallel.pipeline_engine import PipelineParallel
        from .utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                 broadcast_mp_parameters)

        if topo.get_dim("mp") > 1:
            from .meta_parallel.tensor_parallel import apply_dist_specs

            apply_dist_specs(
                model, fleet_state.hcg.get_model_parallel_group())
            broadcast_mp_parameters(model, fleet_state.hcg)
        if topo.get_dim("dp") > 1:
            broadcast_dp_parameters(model, fleet_state.hcg)
        return PipelineParallel(model, fleet_state.hcg, fleet_state.strategy)
    if topo.get_dim("mp") > 1:
        from .meta_parallel.tensor_parallel import TensorParallel

        return TensorParallel(model, fleet_state.hcg, fleet_state.strategy)
    if topo.get_dim("dp") > 1:
        from .utils.hybrid_parallel_util import broadcast_dp_parameters

        broadcast_dp_parameters(model, fleet_state.hcg)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """Wrap ``optimizer`` (a port optimizer over the model's parameters)
    as the reference: a ``DygraphShardingOptimizer`` (each rank keeps and
    updates its slice of the state) when ``sharding_degree > 1``, then
    always a ``HybridParallelOptimizer`` (the distributed clip, the
    replicated-gradient sync over ``mp`` and the gradient average over
    ``dp``)."""
    if not fleet_state.initialized:
        raise RuntimeError("call fleet.init() first")
    from ..sharding.sharding_optimizer import DygraphShardingOptimizer
    from .meta_optimizers import HybridParallelOptimizer

    st = strategy or fleet_state.strategy
    if fleet_state.topology.get_dim("sharding") > 1:
        optimizer = DygraphShardingOptimizer(
            optimizer, hcg=fleet_state.hcg,
            bucket_mb=st.fuse_grad_size_in_MB)
    return HybridParallelOptimizer(optimizer, fleet_state.hcg, st)
