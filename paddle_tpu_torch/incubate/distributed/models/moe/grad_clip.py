"""Expert-aware global-norm clip, after
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``
(``ClipGradForMOEByGlobalNorm``).

Expert parameters live once per expert-parallel rank in the reference, so
their squared norms are summed apart and divided by the moe group's
``nranks`` before they join the others' in the global norm. At one rank
the factor is 1 unless the caller passes a ``moe_group``.

At ep > 1 each rank holds only its experts (their parameters carry the
``expert_group`` that ``MoELayer`` gave them), so the expert squares are
first summed over that group: without a ``moe_group`` that is the
reference's norm over every expert. Every rank of the group takes part in
that sum, so each must hold expert parameters (every rank of an ep layer
does).
"""
from __future__ import annotations

import torch

from .....distributed.collective import all_reduce
from .....nn.clip import ClipGradByGlobalNorm, _sq_sum

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _is_expert(p) -> bool:
    return bool(getattr(p, "is_expert", False))


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """``is_expert_param_func(param)`` picks the expert parameters (by
    default a true ``is_expert`` attribute on the parameter)."""

    def __init__(self, clip_norm=1.0, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm=clip_norm, group_name=group_name)
        self.is_expert = is_expert_param_func or _is_expert
        self.moe_world = getattr(moe_group, "nranks", 1) if moe_group else 1

    def _global_sq_norm(self, params_grads):
        normal, expert, holder = [], [], None
        for p, g in params_grads:
            if self.is_expert(p) and holder is None:
                holder = p
            if g is not None:
                (expert if self.is_expert(p) else normal).append(g)
        sq = _sq_sum(normal) if normal else None
        group = getattr(holder, "expert_group", None)
        if group is not None and group.nranks > 1:
            part = _sq_sum(expert) if expert else torch.zeros(
                (), device=holder.device)
            sq_expert = all_reduce(part.reshape(1).clone(),
                                   group=group)[0]
        elif expert:
            sq_expert = _sq_sum(expert)
        else:
            return sq
        sq_expert = sq_expert / max(1, self.moe_world)
        return sq_expert if sq is None else sq + sq_expert
