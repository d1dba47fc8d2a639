"""The global seed and stream position, after
``paddle_tpu/framework/random.py``.

The reference keeps a process-global seed and a counter that each eager
random draw advances (``next_key``); a checkpoint stores both
(``rng_state_snapshot``), and ``hapi`` derives each epoch's shuffle from
the seed. The port keeps the same two numbers. Its random draws take an
explicit ``torch.Generator``: ``next_generator`` hands out a fresh one
seeded from ``(seed, counter)`` and advances the counter, the port's
``next_key``. torch's own default generator is left alone.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_seed", "next_generator", "get_rng_state",
           "set_rng_state", "rng_state_snapshot", "rng_state_restore"]

_lock = threading.Lock()
_state = {"seed": 0, "counter": 0}


def seed(s: int):
    """Set the global seed (``paddle.seed``) and rewind the stream."""
    with _lock:
        _state["seed"] = int(s)
        _state["counter"] = 0


def get_seed() -> int:
    return _state["seed"]


def next_generator(device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the seed and the
    next stream position."""
    with _lock:
        _state["counter"] += 1
        words = np.random.SeedSequence(
            [_state["seed"], _state["counter"]]).generate_state(2)
    gen = torch.Generator(device=device or "cpu")
    return gen.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)


def get_rng_state():
    return dict(_state)


def set_rng_state(st):
    with _lock:
        _state.update({k: int(st[k]) for k in ("seed", "counter")
                       if k in st})


def rng_state_snapshot() -> dict:
    """``{"seed", "counter"}``: what a checkpoint stores."""
    with _lock:
        return {"seed": int(_state["seed"]),
                "counter": int(_state["counter"])}


def rng_state_restore(snap: dict):
    """Restore a :func:`rng_state_snapshot`: the next ``next_generator``
    draws what the interrupted run's would have."""
    with _lock:
        _state["seed"] = int(snap["seed"])
        _state["counter"] = int(snap["counter"])
