"""The batched spec-decode verifier, after
``paddle_tpu/inference/spec/verifier.py``.

One call scores all k draft positions in ONE forward through the paged
path: the input row is ``[last_tok, d1..dk]``, ``PagedCacheState(verify=
True)`` routes every attention layer through ``paged_state_verify`` (the
k+1 rows land at ``[len, len+k+1)`` and each position attends over the
cache plus the causal prefix, through the verify kernel), and acceptance
runs in the same call, so a verify step costs one fetch. An MoE model's
router stats of the verify forward are kept apart from the other
programs' (``Engine.moe_stats()["verify"]``): the reference does not tap
this program.

The roll-back happens here too: the returned lengths are ``len + 1 +
accepted``, not what was written. Rejected rows become dead data past
``lengths``, and the engine returns their headroom pages
(``Engine._trim_pages``).
"""
from __future__ import annotations

import torch

from ..engine import _moe_tap
from .acceptance import accept_tokens

__all__ = ["make_verify_fn"]


def make_verify_fn(engine, sampling):
    """The verify step for ``engine``; its batch bucket and draft width come
    from the arguments."""
    model = engine.model

    @torch.no_grad()
    def spec_verify_step(tables, lengths, last_tok, drafts, draft_len, temps,
                         keys):
        ids = torch.cat([last_tok[:, None], drafts.long()], dim=1)
        states = engine._states_from(tables, lengths, verify=True)
        with _moe_tap(engine._moe_stats_n) as tap:
            logits, _ = model(ids, caches=states)
        engine._note_moe_stats(tap, verify=True)
        lg = logits.float()
        # any non-finite position in a row's k+1 logits fails that request
        bad = ~torch.isfinite(lg).all(dim=-1).all(dim=-1)
        toks, n_emit, new_keys = accept_tokens(
            lg, drafts, draft_len, temps, keys, top_k=engine.top_k,
            sampling=sampling)
        # keep the accepted prefix; idle/pad rows (length 0) stay 0
        cap = tables.shape[1] * engine.page_size
        new_lengths = torch.where(
            lengths > 0,
            torch.clamp(lengths + n_emit.to(lengths.dtype), max=cap),
            lengths)
        return toks, n_emit, new_lengths, new_keys, bad

    return spec_verify_step
