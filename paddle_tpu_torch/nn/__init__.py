"""Layers of the port (after ``paddle_tpu.nn``)."""
from . import functional, initializer, quant
from .activation import ReLU
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .common import Dropout, Embedding, Linear
from .conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D
from .layer import Layer, LayerList, ParameterList, Sequential
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm2D, LayerNorm, RMSNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, MaxPool1D,
                      MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "quant", "Layer", "LayerList",
           "ParameterList", "Linear", "Embedding", "Dropout",
           "RMSNorm", "LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm2D",
           "Conv1D", "Conv2D",
           "Conv3D", "Conv2DTranspose", "MaxPool1D", "MaxPool2D",
           "AvgPool1D", "AvgPool2D", "AdaptiveAvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "ReLU", "Sequential",
           "CrossEntropyLoss", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
