"""Fused layers (port of ``paddle_tpu.incubate.nn.layer``)."""
from .fused_transformer import (FusedFeedForward, FusedMultiHeadAttention,
                                FusedMultiTransformer,
                                FusedTransformerEncoderLayer)

__all__ = ["FusedFeedForward", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]
