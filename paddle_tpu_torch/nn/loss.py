"""Loss layers, after ``paddle_tpu/nn/loss.py``."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """Softmax cross entropy over hard labels (``F.cross_entropy``). The
    reference's soft labels, ``use_softmax=False`` and label smoothing are
    not ported: those arguments must keep their defaults."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        if soft_label or not use_softmax or label_smoothing:
            raise ValueError("CrossEntropyLoss: soft_label, "
                             "use_softmax=False and label_smoothing are not "
                             "supported by the port")
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.axis = reduction, axis

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction, axis=self.axis)
