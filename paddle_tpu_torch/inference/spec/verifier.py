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

The step is written to be captured (``runner.CapturedStep``): it reads its
inputs from static buffers and writes its results into them, one CUDA
graph per batch bucket and sampling flag on the card, the same body run
eagerly on the CPU.

The roll-back happens here too: the returned lengths are ``len + 1 +
accepted``, not what was written. Rejected rows become dead data past
``lengths``, and the engine returns their headroom pages
(``Engine._trim_pages``).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..engine import _moe_tap
from .acceptance import accept_tokens

__all__ = ["make_verify_fn", "verify_step"]


def verify_step(engine, nb, k, sampling):
    """The capturable verify step over ``nb`` rows of ``k`` drafts:
    (body, static buffers). The body writes the accepted tokens, their
    counts and the non-finite flag into ``toks``, ``n_emit`` and ``bad``,
    the rolled-back lengths and the burnt keys back into ``lengths`` and
    ``keys``, and an MoE model's router stats into ``vstat``."""
    model = engine.model
    moe_n = engine._moe_stats_n

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=engine.device)

    b = SimpleNamespace(
        tables=zeros((nb, engine.max_pages_per_seq), torch.int32),
        lengths=zeros((nb,), torch.int32), last=zeros((nb,), torch.int64),
        drafts=zeros((nb, k), torch.int64),
        draft_len=zeros((nb,), torch.int32),
        temps=zeros((nb,), torch.float32), keys=zeros((nb, 2), torch.int64),
        toks=zeros((nb, k + 1), torch.int64),
        n_emit=zeros((nb,), torch.int64), bad=zeros((nb,), torch.bool),
        vstat=zeros((moe_n,), torch.float32) if moe_n else None)
    cap = engine.max_pages_per_seq * engine.page_size

    def spec_verify_step():
        ids = torch.cat([b.last[:, None], b.drafts], dim=1)
        states = engine._states_from(b.tables, b.lengths, verify=True)
        with _moe_tap(moe_n) as tap:
            logits, _ = model(ids, caches=states)
        if tap:
            b.vstat.copy_(torch.stack(tap).sum(0))
        lg = logits.float()
        # any non-finite position in a row's k+1 logits fails that request
        bad = ~torch.isfinite(lg).all(dim=-1).all(dim=-1)
        toks, n_emit, new_keys = accept_tokens(
            lg, b.drafts, b.draft_len, b.temps, b.keys, top_k=engine.top_k,
            sampling=sampling)
        # keep the accepted prefix; idle/pad rows (length 0) stay 0
        new_lengths = torch.where(
            b.lengths > 0,
            torch.clamp(b.lengths + n_emit.to(b.lengths.dtype), max=cap),
            b.lengths)
        b.toks.copy_(toks)
        b.n_emit.copy_(n_emit)
        b.bad.copy_(bad)
        b.lengths.copy_(new_lengths)
        b.keys.copy_(new_keys)

    return spec_verify_step, b


def make_verify_fn(engine, sampling):
    """The verify step for ``engine``: its batch bucket and draft width
    come from the arguments, and each bucket is captured at its first use.
    Returns (toks, n_emit, lengths, keys, bad) as copies of the step's
    buffers."""
    graphs = engine.runner._graphs

    @torch.no_grad()
    def spec_verify(tables, lengths, last_tok, drafts, draft_len, temps,
                    keys):
        nb, k = drafts.shape
        step = graphs.get(("verify", nb, k, sampling),
                          lambda: verify_step(engine, nb, k, sampling),
                          keep=engine._cache.trash_kept)
        b = step.bufs
        step.load(tables=tables, lengths=lengths, last=last_tok,
                  drafts=drafts, draft_len=draft_len, temps=temps, keys=keys)
        step.run()
        if b.vstat is not None:
            engine._note_moe_stats([b.vstat.clone()], verify=True)
        return (b.toks.clone(), b.n_emit.clone(), b.lengths.clone(),
                b.keys.clone(), b.bad.clone())

    return spec_verify
