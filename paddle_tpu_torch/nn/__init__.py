"""Layers of the port (after ``paddle_tpu.nn``)."""
from . import functional, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["functional", "quant", "Linear", "Embedding", "Dropout",
           "RMSNorm", "LayerNorm", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_"]
