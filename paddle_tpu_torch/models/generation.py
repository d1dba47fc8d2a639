"""Autoregressive generation over the KV cache for the causal-LM families,
after ``paddle_tpu/models/generation.py``.

Mixin contract: the model defines ``forward(input_ids, caches=None,
time_step=None)``, ``init_caches(batch, max_seq, dtype)`` and has a
``config`` with ``max_position``.

One prefill writes the prompt's K/V into slab caches and picks the first
token; then a plain Python loop runs one decode step per token, each
appending its K/V at ``time_step`` and attending over the cache (kernel
#15). PyTorch runs eagerly, so there is no compiled scan and no
power-of-two bucketing of the step count (the reference's bucketing only
computes surplus tokens and slices them off).

Sampling reproduces the reference's key chain bit for bit: ``key =
key(seed)``; ``key, sub = split(key)`` and ``sub`` picks the first token;
the decode loop then does ``rkey, sub = split(rkey)`` once per step from
``rkey = key``. One key draws the noise of the whole ``[B, V]`` logits
(``sampling.categorical_array``), unlike the engine's per-row keys. The
keys are split on the host and only the noise is drawn on the model's
device. Logits are sampled in f32.
"""
from __future__ import annotations

import torch

from ..inference import sampling

__all__ = ["GenerationMixin"]


def _pick_fn(temperature, top_k, dtype):
    """The reference's ``_pick_fn``: argmax when ``temperature == 0`` or
    ``top_k == 1``; else the logits over ``max(temperature, 1e-6)``, those
    below the k-th largest masked to -inf when ``top_k > 1`` (ties with the
    k-th are kept), and a categorical draw with one key for the batch."""
    greedy = temperature == 0.0 or top_k == 1

    def pick(logits_last, key):
        if greedy:
            return torch.argmax(logits_last, dim=-1).to(dtype)
        lg = logits_last.float() / max(temperature, 1e-6)
        if top_k > 1:
            kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")),
                             lg)
        return sampling.categorical_array(key.to(lg.device), lg).to(dtype)

    return pick, greedy


class GenerationMixin:
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, seed=0, max_seq=None):
        """Autoregressive generation over the KV cache. Greedy when
        ``temperature == 0`` (or ``top_k == 1``); otherwise samples from
        the (optionally top-k-truncated) softmax. ``input_ids`` [B, prompt]
        (a tensor or an array; moved to the model's device). Returns
        ``[B, prompt + new]`` ids in the input's dtype. Runs in eval mode
        under ``torch.no_grad()`` and restores training mode after."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self._generate(input_ids, max_new_tokens, temperature,
                                      top_k, seed, max_seq)
        finally:
            if was_training:
                self.train()

    def _generate(self, input_ids, max_new_tokens, temperature, top_k, seed,
                  max_seq):
        ids = torch.as_tensor(input_ids, device=self.device)
        b, prompt = ids.shape
        if max_new_tokens <= 0:
            return ids
        total = max_seq or min(self.config.max_position,
                               prompt + max_new_tokens)
        # the cache in the model's compute dtype: a bf16 model must not pay
        # f32 cache bandwidth in the decode loop
        pdtype = next(p.dtype for p in self.parameters())
        if not pdtype.is_floating_point:
            pdtype = torch.float32
        caches = self.init_caches(b, total, dtype=pdtype)
        logits, caches = self(ids, caches=caches)
        pick, greedy = _pick_fn(temperature, top_k, ids.dtype)
        key = torch.tensor(sampling.key_from_seed(seed), dtype=torch.int64)
        sub = None
        if not greedy:
            key, sub = sampling.split(key)
        nxt = pick(logits[:, -1], sub)
        out = [ids, nxt[:, None]]
        # the token emitted after prefill sits at position `prompt`; step t
        # writes its K/V at cache row t and predicts token t + 1
        steps = min(max_new_tokens - 1, total - 1 - prompt)
        rkey = key
        for i in range(steps):
            logits, caches = self(nxt[:, None], caches=caches,
                                  time_step=prompt + i)
            if not greedy:
                rkey, sub = sampling.split(rkey)
            nxt = pick(logits[:, -1], sub)
            out.append(nxt[:, None])
        return torch.cat(out, dim=1)
