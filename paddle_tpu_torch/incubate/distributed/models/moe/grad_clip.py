"""Expert-aware global-norm clip, after
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``
(``ClipGradForMOEByGlobalNorm``).

Expert parameters live once per expert-parallel rank in the reference, so
their squared norms are summed apart and divided by the moe group's
``nranks`` before they join the others' in the global norm. At one rank
the factor is 1 unless the caller passes a ``moe_group``.
"""
from __future__ import annotations

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
        normal, expert = [], []
        for p, g in params_grads:
            if g is not None:
                (expert if self.is_expert(p) else normal).append(g)
        sq = _sq_sum(normal) if normal else None
        if expert:
            sq_expert = _sq_sum(expert) / max(1, self.moe_world)
            sq = sq_expert if sq is None else sq + sq_expert
        return sq
