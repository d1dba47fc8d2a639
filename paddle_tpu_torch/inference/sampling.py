"""Counter-based sampling that reproduces ``jax.random`` bit for bit.

The JAX engine threads raw threefry2x32 keys (``[2]`` uint32 per slot)
through ``jax.random.split`` and ``jax.random.categorical``; this module is
the same arithmetic in torch integer ops, so a sampled stream served by the
port is token-exact against the reference. Values are uint32 held in int64
tensors and masked with ``& 0xFFFFFFFF`` after every add and shift.

It follows JAX's defaults: the ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (counters are the row-major flat index
split into hi/lo 32-bit words; ``split`` hashes counters (0, i) and keeps
both output words; 32-bit ``random_bits`` XOR the two words), ``uniform``
by the mantissa trick and the "low" gumbel mode.

Also here: the engine's token choice ``select_token`` (JAX
``Engine._select_token``) and ``advance_sample_key`` (JAX
``_advance_sample_key``), which replays one split per delivered token.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["threefry2x32", "split", "random_bits", "uniform", "gumbel",
           "categorical", "categorical_array", "key_from_seed",
           "select_token", "advance_sample_key"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on broadcastable int64 tensors holding
    uint32 values. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _counters(n, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M


def split(key, num=2):
    """``jax.random.split`` of raw keys: key ``[..., 2]`` → ``[..., num,
    2]``."""
    key = key.long()
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape):
    """32-bit ``jax.random.bits``: key ``[..., 2]`` → uint32 values (int64)
    of shape ``key.shape[:-1] + shape``."""
    key = key.long()
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """f32 ``jax.random.uniform``: random mantissa bits under exponent 0,
    minus one, scaled to ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    fl = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    fl = fl - 1.0
    # the bounds as f32 device scalars filled on the device (no host copy,
    # so a CUDA graph can capture the draw); hi - lo is taken in f32
    lo = torch.full((), minval, dtype=torch.float32, device=fl.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=fl.device)
    return torch.maximum(lo, fl * (hi - lo) + lo)


def gumbel(key, shape):
    """f32 ``jax.random.gumbel`` ("low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis, one key per row:
    key ``[..., 2]``, logits ``[..., V]`` → ``argmax(logits + gumbel)``."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def categorical_array(key, logits):
    """``jax.random.categorical(key, logits)`` on a 2-D array with ONE key
    for the whole array (``GenerationMixin``'s form): key ``[2]``, logits
    ``[B, V]`` → ``argmax(logits + gumbel(key, (B, V)))`` per row, the
    gumbel noise drawn over the flat ``B * V`` counters."""
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=-1)


def key_from_seed(seed: int):
    """The raw threefry key ``jax.random.PRNGKey(seed)`` builds, as a
    Python pair: (high word, low word)."""
    seed = int(seed)
    return ((seed >> 32) & _M, seed & _M)


def select_token(logits, greedy_tok, temps, keys, top_k: Optional[int]):
    """The engine's token choice: argmax where ``temps == 0``, top-k
    temperature sampling otherwise. ``logits`` [B, V] f32, ``keys`` [B, 2]
    (uint32 values in int64). Returns ``(tok [B] int64, new_keys)``; only
    sampling rows burn a key split."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
        logits = torch.where(logits >= kth[:, None], logits,
                             torch.full_like(logits, float("-inf")))
    splits = split(keys)                      # [B, 2, 2]
    new_keys, step_keys = splits[:, 0], splits[:, 1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = categorical(step_keys, scaled)
    samp = temps > 0.0
    tok = torch.where(samp, sampled, greedy_tok)
    new_keys = torch.where(samp[:, None], new_keys, keys.long())
    return tok, new_keys


def advance_sample_key(key, burns: int):
    """Replay ``burns`` key splits (one per delivered token of a sampled
    stream): ``split(key)[0]`` applied ``burns`` times."""
    key = key.long()
    for _ in range(int(burns)):
        key = split(key)[..., 0, :]
    return key
