"""Model-runner of the serving engine, after
``paddle_tpu/inference/runner.py`` on its single-device path (tp=None).

In the JAX package the runner jits (and at tp > 1 shard_maps) the engine's
programs and caches one compiled program per shape bucket. PyTorch runs
eagerly, so here it only builds and caches the engine's callables: the
bucketed prefill (classic, or the prefix cache's suffix prefill), the
chained decode, chunked prefill's mixed step and the spec-decode verify
step. There is no mesh. Each new shape key counts one
``paddle_serving_compiled_programs_total{kind}`` as the reference counts
its compiles, so both engines report the same program lattice.
"""
from __future__ import annotations

from typing import Callable, Dict, Set, Tuple

__all__ = ["ModelRunner"]


class ModelRunner:
    """Builds and caches the engine's callables per shape bucket."""

    def __init__(self, engine):
        self.engine = engine
        self.decode_fns: Dict[Tuple, Callable] = {}
        self.prefill_fns: Dict[Tuple, Callable] = {}
        self.mixed_fns: Dict[Tuple, Callable] = {}
        self.verify_fns: Dict[bool, Callable] = {}
        self._verify_shapes: Set[Tuple[int, bool]] = set()

    def _count(self, kind: str):
        m = self.engine._m
        if m is not None:
            m.compiled.labels(kind=kind).inc()

    def get_decode(self, nb: int, k: int, sampling: bool) -> Callable:
        key = (nb, k, sampling)
        fn = self.decode_fns.get(key)
        if fn is None:
            self._count("decode")
            fn = self.decode_fns[key] = self.engine._make_decode_raw(
                k, sampling)
        return fn

    def get_prefill(self, bucket: Tuple[int, int], sampling: bool,
                    suffix: bool = False) -> Callable:
        """``suffix=True``: the prefix cache's partial prefill, whose
        attention goes through the verify kernel over the cached prefix."""
        key = (bucket, sampling, suffix)
        fn = self.prefill_fns.get(key)
        if fn is None:
            self._count("prefill")
            fn = self.prefill_fns[key] = self.engine._make_prefill_raw(
                sampling, suffix)
        return fn

    def get_mixed(self, nb: int, sampling: bool) -> Callable:
        """Chunked prefill's mixed chunk+decode step."""
        key = (nb, sampling)
        fn = self.mixed_fns.get(key)
        if fn is None:
            self._count("mixed")
            from .engine import make_mixed_step_fn

            fn = self.mixed_fns[key] = make_mixed_step_fn(self.engine,
                                                          sampling)
        return fn

    def note_verify_shape(self, nb: int, sampling: bool):
        """Count a verify program the first time its padded batch ``nb``
        runs (the reference compiles one per shape)."""
        if (nb, sampling) not in self._verify_shapes:
            self._verify_shapes.add((nb, sampling))
            self._count("verify")

    def get_verify(self, sampling: bool) -> Callable:
        """The spec-decode verify step (one per sampling flag; its shapes
        come from its arguments)."""
        fn = self.verify_fns.get(sampling)
        if fn is None:
            from .spec.verifier import make_verify_fn

            fn = self.verify_fns[sampling] = make_verify_fn(self.engine,
                                                            sampling)
        return fn
