"""Hybrid-parallel sync helpers (after
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``).

``fused_allreduce_gradients`` averages the gradients over the data-parallel
group in the buckets ``DataParallel`` uses (one all-reduce a bucket of
about ``bucket_mb`` MB, not one a parameter); an expert-parallel
``MoELayer``'s expert parameters are left out and divided by ep instead
(``parallel.sync_gradients``). The ``broadcast_*`` helpers copy every
parameter from the first rank of a group to the others; the mp one skips
the parameters split over ``mp`` (``is_distributed``), the dp one the
expert-parallel ones (each rank holds other experts).
"""
from __future__ import annotations

import torch

from ...parallel import get_world_size, is_expert_parallel, sync_gradients

__all__ = ["fused_allreduce_gradients", "broadcast_dp_parameters",
           "broadcast_mp_parameters", "broadcast_sharding_parameters"]


def fused_allreduce_gradients(parameter_list, hcg=None,
                              bucket_mb: float = 25) -> int:
    """Average the gradients of ``parameter_list`` over ``hcg``'s
    data-parallel group (the world without one), the expert-parallel ones
    divided by ep instead. Returns the number of all-reduce calls."""
    if get_world_size() <= 1:
        return 0
    group = hcg.get_data_parallel_group() if hcg is not None else None
    return sync_gradients(parameter_list, group, bucket_mb)


@torch.no_grad()
def _broadcast(params, group):
    from ...collective import broadcast

    if get_world_size() <= 1 or group.nranks <= 1:
        return
    for p in params:
        broadcast(p.data, group.ranks[0], group=group)


def broadcast_dp_parameters(model, hcg):
    _broadcast([p for p in model.parameters() if not is_expert_parallel(p)],
               hcg.get_data_parallel_group())


def broadcast_mp_parameters(model, hcg):
    _broadcast([p for p in model.parameters()
                if getattr(p, "is_distributed", False) is not True],
               hcg.get_model_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    _broadcast(model.parameters(), hcg.get_sharding_parallel_group())
