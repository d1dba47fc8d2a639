"""Gradient clipping, after ``paddle_tpu/nn/clip.py``
(``ClipGradByGlobalNorm`` / ``ByNorm`` / ``ByValue``, ``clip_grad_norm_``).

A clip object takes ``[(param, grad), ...]`` and returns the list with the
gradients clipped; the optimizer calls it inside ``step``. Norms are taken
in f32 and every scale stays a device tensor, so clipping never waits for
the device. Gradients are scaled in place and keep their dtype.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_"]


def _sq_sum(grads):
    """Σ‖g‖² over ``grads``, each norm taken in f32."""
    return torch.stack([
        torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
        for g in grads]).sum()


def _scale_for(norm, clip_norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-6), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / ||g||, 1)``, ``||g||`` the
    f32 global 2-norm over all gradients."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _global_sq_norm(self, params_grads):
        """Σ‖g‖² in f32 over the gradients (a 0-dim device tensor), None
        when there is none. Variants override it (the MoE clip weighs
        expert gradients apart)."""
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return None
        return _sq_sum(grads)

    def __call__(self, params_grads):
        sq = self._global_sq_norm(params_grads)
        if sq is None:
            return params_grads
        scale = _scale_for(torch.sqrt(sq), self.clip_norm)
        for _, g in params_grads:
            if g is not None:
                g.mul_(scale)
        return params_grads


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by ``min(clip_norm / ||g||, 1)`` on its own."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                n = torch.linalg.vector_norm(g, dtype=torch.float32)
                g.mul_(_scale_for(n, self.clip_norm))
        return params_grads


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def __call__(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.clamp_(self.min, self.max)
        return params_grads


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` in place so their joint
    ``norm_type``-norm is at most ``max_norm``; returns that norm (f32,
    taken before clipping)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([
            torch.sum(g.float().abs() ** norm_type) for g in grads
        ]).sum() ** (1.0 / norm_type)
    scale = _scale_for(total, float(max_norm))
    for g in grads:
        g.mul_(scale)
    return total
