"""Functional ops of the port (after ``paddle_tpu.nn.functional``)."""
from __future__ import annotations

from .activation import gelu, relu, silu
from .attention import (flash_attention, naive_attention,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["linear", "dropout", "embedding", "silu", "gelu", "relu",
           "rms_norm", "layer_norm", "cross_entropy", "flash_attention",
           "naive_attention", "scaled_dot_product_attention"]
