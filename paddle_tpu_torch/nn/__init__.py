"""Layers of the port (after ``paddle_tpu.nn``)."""
from . import functional, quant
from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["functional", "quant", "Linear", "Embedding", "RMSNorm"]
