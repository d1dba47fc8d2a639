"""Draft-token acceptance for speculative decoding, after
``paddle_tpu/inference/spec/acceptance.py``.

Runs inside the engine's verify step on the device, with no host sync.
Point-mass proposals (the n-gram drafter proposes fixed tokens):

* **Greedy rows** (``temperature == 0``): accept the longest prefix of
  drafts that matches the target argmax chain, then emit the argmax at
  the first mismatch. The stream is the vanilla greedy chain by
  construction. Key state is untouched.
* **Sampled rows**: accept draft ``d`` at position ``j`` with probability
  ``p_j(d)``; at the first rejection sample the bonus token from ``p``
  with the rejected token removed, else from ``p`` itself. ``k + 2``
  subkeys are burnt per row and verify step, whatever the acceptance.

The random draws are the port's bit-exact ``jax.random`` (``sampling``),
so tokens, counts and keys equal the JAX package's on the same inputs.
Top-k filtering and temperature scaling follow ``select_token``'s order.
"""
from __future__ import annotations

import torch

from ..sampling import categorical, split, uniform

__all__ = ["accept_tokens"]


def accept_tokens(logits, drafts, draft_len, temps, keys, top_k=None,
                  sampling=True):
    """Score a verify block and pick the accepted tokens.

    logits [B, k+1, V] f32; drafts [B, k] (valid up to ``draft_len`` [B]);
    temps [B] f32 (0 = greedy); keys [B, 2] (uint32 values in int64);
    ``sampling=False`` skips the random draws (an all-greedy batch).

    Returns ``(toks [B, k+1], n_emit [B], new_keys [B, 2])``:
    ``toks[b, :n_emit[b]]`` is the accepted draft prefix followed by one
    bonus/correction token, zero-padded."""
    b, m, v = logits.shape
    k = m - 1
    dev = logits.device
    drafts = drafts.long()
    keys = keys.long()
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1]
        logits = torch.where(logits >= kth[..., None], logits,
                             torch.full_like(logits, float("-inf")))
    greedy = torch.argmax(logits, dim=-1)  # [B, m]
    j = torch.arange(k, device=dev)[None]
    valid = j < draft_len.long()[:, None]  # [B, k]
    accept_greedy = valid & (drafts == greedy[:, :k])
    rows = torch.arange(b, device=dev)

    if not sampling:
        accept = accept_greedy
        new_keys = keys
        n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
        bonus = greedy[rows, n_acc]
    else:
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None, None]
        probs = torch.softmax(scaled, dim=-1)  # [B, m, V]
        splits = split(keys, k + 2)  # [B, k+2, 2]
        new_keys = splits[:, 0]
        u = uniform(splits[:, 1:k + 1], ())  # [B, k] in [0, 1)
        p_draft = torch.gather(probs[:, :k], 2, drafts[..., None])[..., 0]
        accept_sampled = valid & (u < p_draft)
        samp = temps > 0.0
        accept = torch.where(samp[:, None], accept_sampled, accept_greedy)
        n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [B]
        final_scaled = scaled[rows, n_acc]  # [B, V]
        rejected = n_acc < draft_len.long()
        rej_tok = drafts[rows, torch.clamp(n_acc, 0, k - 1)]
        drop = ((torch.arange(v, device=dev)[None] == rej_tok[:, None])
                & rejected[:, None])
        final_scaled = torch.where(drop, torch.full_like(final_scaled,
                                                         float("-inf")),
                                   final_scaled)
        sampled_bonus = categorical(splits[:, k + 1], final_scaled)
        bonus = torch.where(samp, sampled_bonus, greedy[rows, n_acc])
        new_keys = torch.where(samp[:, None], new_keys, keys)

    pos = torch.arange(m, device=dev)[None]
    draft_pad = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.long,
                                               device=dev)], dim=1)
    toks = torch.where(pos < n_acc[:, None], draft_pad,
                       torch.where(pos == n_acc[:, None], bonus[:, None],
                                   torch.zeros_like(draft_pad)))
    return toks, n_acc + 1, new_keys
