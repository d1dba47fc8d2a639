"""Functional ops of the port (after ``paddle_tpu.nn.functional``)."""
from __future__ import annotations

from .activation import gelu, relu, silu
from .attention import (flash_attention, naive_attention,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .conv import conv1d, conv2d, conv2d_transpose, conv3d
from .loss import cross_entropy
from .norm import (batch_norm, group_norm, layer_norm, local_response_norm,
                   rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      max_pool1d, max_pool2d)

__all__ = ["linear", "dropout", "embedding", "silu", "gelu", "relu",
           "rms_norm", "layer_norm", "batch_norm", "group_norm",
           "local_response_norm", "cross_entropy", "flash_attention",
           "naive_attention", "scaled_dot_product_attention", "conv1d",
           "conv2d", "conv3d", "conv2d_transpose", "max_pool1d",
           "max_pool2d", "avg_pool1d", "avg_pool2d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d"]
