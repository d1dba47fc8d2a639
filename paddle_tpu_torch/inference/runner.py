"""Model-runner of the serving engine, after
``paddle_tpu/inference/runner.py`` on its single-device path (tp=None).

In the JAX package the runner jits (and at tp > 1 shard_maps) the engine's
programs and caches one compiled program per shape bucket. PyTorch runs
eagerly, so here it only builds and caches the per-bucket prefill and
decode callables; there is no mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["ModelRunner"]


class ModelRunner:
    """Builds and caches the engine's prefill and decode callables."""

    def __init__(self, engine):
        self.engine = engine
        self.decode_fns: Dict[Tuple, Callable] = {}
        self.prefill_fns: Dict[Tuple, Callable] = {}

    def get_decode(self, nb: int, k: int, sampling: bool) -> Callable:
        key = (nb, k, sampling)
        fn = self.decode_fns.get(key)
        if fn is None:
            fn = self.decode_fns[key] = self.engine._make_decode_raw(
                k, sampling)
        return fn

    def get_prefill(self, bucket: Tuple[int, int], sampling: bool
                    ) -> Callable:
        key = (bucket, sampling)
        fn = self.prefill_fns.get(key)
        if fn is None:
            fn = self.prefill_fns[key] = self.engine._make_prefill_raw(
                sampling)
        return fn
