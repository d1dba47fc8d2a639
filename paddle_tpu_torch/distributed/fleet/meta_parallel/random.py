"""The model-parallel RNG state tracker (after
``paddle_tpu/distributed/fleet/meta_parallel/random.py``):
``RNGStatesTracker``, ``get_rng_state_tracker``,
``model_parallel_random_seed``.

The contract: random draws inside ``rng_state(name)`` (dropout masks of
mp-sharded activations, the draws of mp-sharded parameters) differ across
``mp`` ranks, and draws outside it (the global stream of
``framework.random``) agree on every rank. The port's random draws take
``torch.Generator``s that ``framework.random.next_generator`` hands out
from a (seed, counter) pair. A named state is such a pair of its own:
inside ``rng_state(name)`` the global pair is swapped for the named one,
whose seed has this rank's ``mp`` coordinate folded in (the reference
folds it into the named key), and the named counter advances with every
draw made there.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ....framework import random as _random

MODEL_PARALLEL_RNG = "model_parallel_rng"

__all__ = ["MODEL_PARALLEL_RNG", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed"]


def _fold(seed: int, rank: int) -> int:
    words = np.random.SeedSequence([int(seed), int(rank)]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


class RNGStatesTracker:
    """Named RNG states: ``add(name, seed)`` registers one,
    ``rng_state(name)`` makes it the source of the random draws made inside
    it."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()
        self._mp_rank = 0

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = {"seed": int(seed), "counter": 0}

    def get_states_tracker(self):
        return {k: dict(v) for k, v in self.states_.items()}

    def set_states_tracker(self, states):
        self.states_ = {k: dict(v) for k, v in states.items()}

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        st = self.states_[name]
        outer = _random.rng_state_snapshot()
        _random.rng_state_restore(
            {"seed": _fold(st["seed"], self._mp_rank),
             "counter": st["counter"]})
        try:
            yield
        finally:
            st["counter"] = _random.rng_state_snapshot()["counter"]
            _random.rng_state_restore(outer)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 0):
    """Install the reference's seeds: the global seed ``seed`` on every
    rank, and the ``model_parallel_rng`` state (``seed + 1024``) with this
    rank's ``mp`` coordinate (``fleet``'s, 0 without it) folded in."""
    from ..fleet_base import fleet_state

    mp_rank = 0
    if fleet_state.initialized and fleet_state.hcg is not None:
        mp_rank = fleet_state.hcg.get_model_parallel_rank()
    _tracker.reset()
    _random.seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024)
    _tracker._mp_rank = mp_rank


def determinate_seed(rng_name: str) -> int:
    """A deterministic seed from the named state (the seed of its next
    draw), else the global seed."""
    st = _tracker.states_.get(rng_name)
    if st is not None:
        return _fold(st["seed"], _tracker._mp_rank) % (2 ** 31)
    return _random.get_seed()
