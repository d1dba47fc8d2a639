"""Mixture of experts at one rank (port of
``paddle_tpu.incubate.distributed.models.moe``): the layer, its gates, the
ragged expert compute on the grouped matmul kernel and the expert-aware
clip. Expert parallelism is not ported."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import (ExpertFFN, MoELayer, count_by_gate, gshard_dispatch,
                        limit_by_capacity)
from .ragged import moe_ragged_ffn, padded_flops_fraction, ragged_routing

__all__ = [
    "MoELayer", "ExpertFFN", "BaseGate", "NaiveGate", "GShardGate",
    "SwitchGate", "count_by_gate", "limit_by_capacity", "gshard_dispatch",
    "moe_ragged_ffn", "ragged_routing", "padded_flops_fraction",
    "ClipGradForMOEByGlobalNorm",
]
