"""DistributedStrategy (after
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the hybrid
degrees ``fleet.init`` lays the ranks out by, ``sep_degree`` included,
and the reference's other knobs under its names and defaults (amp,
recompute, sharding, pipeline, gradient merge, dgc, lamb, the fused
all-reduce). ``fleet.distributed_optimizer`` reads
``fuse_grad_size_in_MB`` (the size of its all-reduce buckets); the
others are held under the reference's names, as the reference holds
them (its ``distributed_optimizer`` reads none of them either).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class HybridConfigs:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


class DistributedStrategy:
    def __init__(self):
        self._hybrid = HybridConfigs()
        self.amp = False
        self.amp_configs: Dict = {
            "init_loss_scaling": 32768.0, "use_pure_fp16": False,
            "use_pure_bf16": False, "custom_white_list": [],
            "custom_black_list": [],
        }
        self.recompute = False
        self.recompute_configs: Dict = {"checkpoints": [],
                                        "granularity": "full"}
        self.sharding = False
        self.sharding_configs: Dict = {"stage": 1, "degree": 1,
                                       "offload": False}
        self.pipeline = False
        self.pipeline_configs: Dict = {"accumulate_steps": 1,
                                       "micro_batch_size": 1,
                                       "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.dgc = False
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict = {"tensor_parallel_degree": 1}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32

    @property
    def hybrid_configs(self) -> Dict:
        return {
            "dp_degree": self._hybrid.dp_degree,
            "mp_degree": self._hybrid.mp_degree,
            "pp_degree": self._hybrid.pp_degree,
            "sharding_degree": self._hybrid.sharding_degree,
            "sep_degree": self._hybrid.sep_degree,
        }

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict):
        for k, v in configs.items():
            key = k if k.endswith("_degree") else f"{k}_degree"
            if not hasattr(self._hybrid, key):
                raise ValueError(f"unknown hybrid config {k!r}")
            setattr(self._hybrid, key, int(v))

    def __repr__(self):
        return (f"DistributedStrategy(hybrid={self.hybrid_configs}, "
                f"amp={self.amp}, recompute={self.recompute}, "
                f"sharding={self.sharding}, pipeline={self.pipeline})")
