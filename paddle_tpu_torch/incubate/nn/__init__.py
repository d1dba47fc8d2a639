"""Fused layers and ops (port of ``paddle_tpu.incubate.nn``)."""
from . import functional
from .layer import (FusedFeedForward, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedFeedForward", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]
