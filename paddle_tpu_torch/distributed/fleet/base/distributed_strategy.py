"""DistributedStrategy (after
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the hybrid
degrees ``fleet.init`` lays the ranks out by, ``sep_degree`` included,
under the reference's knob names. The reference's other knobs (amp,
recompute, sharding, pipeline, ...) configure multi-GPU training, which is
not ported.
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
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"
