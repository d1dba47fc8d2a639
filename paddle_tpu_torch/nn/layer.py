"""Containers, after ``paddle_tpu/nn/layer.py``."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential"]


class Sequential(nn.Sequential):
    """Layers called in order. Children are named ``"0"``, ``"1"``, ...
    (as in torch and the reference), or by ``(name, layer)`` pairs; one
    list or tuple of layers may stand for the arguments."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        super().__init__(OrderedDict(
            tuple(item) if isinstance(item, (list, tuple)) else (str(i), item)
            for i, item in enumerate(layers)))
