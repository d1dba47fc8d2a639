"""Losses, after ``paddle_tpu/nn/functional/loss.py``. Computed in f32."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", axis=-1):
    """Softmax cross entropy of logits ``input`` against integer labels
    (hard labels only). Labels equal to ``ignore_index`` give loss 0 and,
    under ``"mean"``, do not count in the denominator. ``weight`` scales
    each class's loss."""
    if label.dim() == input.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    logp = torch.log_softmax(input.float(), dim=axis)
    valid = label != ignore_index
    idx = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(axis, idx.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight.float()[idx]
    loss = torch.where(valid, loss, torch.zeros((), device=loss.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    if reduction != "none":
        raise ValueError(f"unknown reduction {reduction!r}")
    return loss
