"""The drafters of speculative decoding, after
``paddle_tpu/inference/spec/drafter.py``.

``propose(engine, slots, reqs, want, k)`` returns ``(drafts, dlen)``:
``drafts`` a ``[pow2ceil(n), k]`` integer array or device tensor in
sorted-slot batch order, ``dlen[i] <= k`` (host numpy) the valid proposals
of row i.

* ``NgramDrafter``: model-free prompt lookup. Match the request's most
  recent n-gram earlier in its own prompt and generation, and propose the
  tokens that followed. Pure host numpy, no device work.
* ``DraftModelDrafter``: a small causal LM drafts k tokens by greedy
  decode over its OWN paged KV pool (the engine's page and table
  machinery, page 0 the trash page). Before each proposal ``_sync``
  reconciles each slot's draft cache with the request's host-side history:
  it rolls back rejected draft rows, and a catch-up forward (verify mode,
  through the verify kernel #3, logits discarded) writes the tokens the
  cache lacks; a new request, a preemption or a reused slot re-prefills
  from the drafter's own prefix cache or from scratch. The k greedy steps
  (the decode kernel #1, f32 argmax, the first index winning ties) are
  one capturable step, a CUDA graph per ``(nb, k)`` bucket on the card
  (``runner.GraphSet``), the counterpart of the reference's jitted scan;
  the catch-up runs eagerly, its widths in power-of-two buckets. The
  drafts stay on the device: the verify step consumes them there.

One divergence from the reference, chosen: the catch-up forward marks
each row's width (``prefill_valid``), so a row whose draft cache is empty
(a new request with no cached prefix) writes its tokens. The reference's
catch-up runs the spec-verify form, which treats a row at length 0 as
idle and sends its writes to the trash page: its draft cache holds no
prompt, and a target passed as its own draft accepts few of its drafts
where every one should land (ROADMAP.md queue C).
"""
from __future__ import annotations

from types import SimpleNamespace
import numpy as np
import torch

__all__ = ["NgramDrafter", "DraftModelDrafter"]


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _history(req) -> np.ndarray:
    """Prompt plus everything generated, the current last token included
    (drafting continues from it)."""
    if req.tokens:
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
    return np.asarray(req.prompt, np.int32)


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the latest
    earlier occurrence of the current tail n-gram, longest n first."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _lookup(self, ctx: np.ndarray, want: int) -> np.ndarray:
        L = ctx.size
        if want <= 0 or L < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = ctx[L - n:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            # earlier occurrences with at least one continuation token
            hits = hits[hits <= L - n - 1]
            if not hits.size:
                continue
            # the latest hit whose continuation is a full window (in a
            # repetition run the latest hit sits against the end of the
            # context and would cut the proposal short), else the latest
            full = hits[hits <= L - n - want]
            j = int(full[-1] if full.size else hits[-1]) + n
            return ctx[j:j + want].astype(np.int32)
        return np.zeros((0,), np.int32)

    def propose(self, engine, slots, reqs, want, k):
        n = len(reqs)
        drafts = np.zeros((_pow2ceil(max(n, 1)), k), np.int32)
        dlen = np.zeros((n,), np.int32)
        for i, req in enumerate(reqs):
            got = self._lookup(_history(req), min(int(want[i]), k))
            drafts[i, :got.size] = got
            dlen[i] = got.size
        return drafts, dlen

    def release(self, slot):  # stateless
        pass

    def reset(self):  # stateless; must never raise
        pass


class DraftModelDrafter:
    """Draft with a small causal LM over its own paged KV pool (see the
    module doc). The draft model must share the target's vocabulary, device
    and dtype (its pages are read in its activations' dtype)."""

    name = "draft"

    def __init__(self, model, engine):
        cfg = model.config
        if cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({cfg.vocab_size}) must match the "
                f"target's ({engine.cfg.vocab_size})")
        if model.device != engine.device:
            raise ValueError(f"draft model lives on {model.device}, engine "
                             f"on {engine.device}")
        if model.dtype != engine.dtype:
            raise ValueError(f"draft model dtype {model.dtype} must match "
                             f"the engine's {engine.dtype}")
        from ..cache_coord import CacheCoordinator
        from ..runner import GraphSet

        self.model = model
        self.cfg = cfg
        self.device = engine.device
        self.dtype = model.dtype
        self.page_size = engine.page_size
        self.num_pages = engine.num_pages
        self.max_pages_per_seq = min(engine.max_pages_per_seq,
                                     cfg.max_position // engine.page_size)
        # the engine's pool machinery over a pool of the draft model's own
        # (page 0 the trash page, refcounts, free list; other content, so
        # a prefix cache of its own, on iff the engine's is: a re-prefill
        # splices cached draft pages), seen through a stand-in engine that
        # carries the draft's widths and no metrics, faults or sentinel
        self._cache = CacheCoordinator(
            SimpleNamespace(cfg=cfg, num_pages=self.num_pages,
                            page_size=self.page_size,
                            max_slots=engine.max_slots,
                            max_pages_per_seq=self.max_pages_per_seq,
                            device=self.device, dtype=self.dtype,
                            quantized=False, _m=None, _integrity=None,
                            _fi=None),
            prefix_cache=engine._pcache is not None)
        self.tables, self.lengths = self._cache.tables, self._cache.lengths
        self.k_pages, self.v_pages = self._cache.k_pages, self._cache.v_pages
        self._slot_rid = np.full((engine.max_slots,), -1, np.int64)
        self._last = np.zeros((engine.max_slots,), np.int64)
        # the propose steps, one per (nb, k); ``enabled = False`` runs
        # them eagerly (chip_smoke.py's eager twin)
        self._graphs = GraphSet(self.device)

    # ------------------------------------------------------- allocator
    def _pages_needed(self, length):
        return (int(length) + self.page_size - 1) // self.page_size

    def _ensure_pages(self, slot, new_len) -> bool:
        return self._cache.grow(slot, min(self._pages_needed(new_len),
                                          self.max_pages_per_seq))

    def release(self, slot):
        """Forget a slot (request finished, preempted or its slot reused).
        Cached draft pages stay resident at refcount 0."""
        self._cache.release_slot(slot)
        self._slot_rid[slot] = -1

    def reset(self):
        """Drop every slot and cached page and zero the pages (after a
        drafter fault or an engine pool reset); ``_sync`` then re-prefills
        every slot from its request's history. The pages are zeroed IN
        PLACE: the captured propose graphs read them by address. Never
        raises."""
        with torch.no_grad():
            for t in self.k_pages + self.v_pages:
                t.zero_()
        self._cache.reset()
        self._slot_rid[:] = -1

    # ------------------------------------------------- device programs
    def _states(self, tables, lengths, prefill_valid=None, verify=False):
        from ...ops.cuda.paged_attention import PagedCacheState

        return [PagedCacheState(self.k_pages[i], self.v_pages[i], None,
                                tables, lengths, self.page_size,
                                prefill_valid=prefill_valid, verify=verify)
                for i in range(self.cfg.num_layers)]

    def _dev(self, a):
        return torch.from_numpy(a).to(self.device)

    def _catch_up(self, rows):
        """Write each row's missing tokens ``(slot, tokens)`` into the draft
        cache in one eager verify-mode forward (rows and width padded to
        powers of two; each row's width marked, so a row at length 0
        prefills from scratch and the padding writes the trash page); the
        logits are discarded."""
        width = _pow2ceil(max(d.size for _, d in rows))
        rb = _pow2ceil(len(rows))
        ids = np.zeros((rb, width), np.int64)
        tables = np.zeros((rb, self.max_pages_per_seq), np.int32)
        lengths = np.zeros((rb,), np.int32)
        delta = np.zeros((rb,), np.int32)
        for i, (s, d) in enumerate(rows):
            ids[i, :d.size] = d
            tables[i] = self.tables[s]
            lengths[i] = self.lengths[s]
            delta[i] = d.size
        with torch.no_grad():
            self.model(self._dev(ids), caches=self._states(
                self._dev(tables), self._dev(lengths),
                prefill_valid=self._dev(delta), verify=True))
        for i, (s, _) in enumerate(rows):
            self.lengths[s] = int(lengths[i] + delta[i])

    def _propose_step(self, nb, k):
        """The capturable k-step greedy decode over ``nb`` rows: (body,
        static buffers). It reads ``tables``, ``lengths`` and ``last``,
        writes each step's argmax into ``toks`` [nb, k] and the advanced
        lengths back; rows at length 0 idle on the trash page."""
        model = self.model

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        b = SimpleNamespace(
            tables=zeros((nb, self.max_pages_per_seq), torch.int32),
            lengths=zeros((nb,), torch.int32),
            last=zeros((nb,), torch.int64),
            toks=zeros((nb, k), torch.int64))

        def draft_propose_step():
            states = self._states(b.tables, b.lengths)
            tok = b.last
            for j in range(k):
                logits, states = model(tok[:, None], caches=states)
                tok = torch.argmax(logits[:, -1].float(), dim=-1)
                b.toks[:, j].copy_(tok)
            b.lengths.copy_(states[0].lengths)

        return draft_propose_step, b

    def _run_propose(self, slots, nb, k):
        """The k greedy steps for ``slots`` (batch order, padded to ``nb``
        idle rows): the step of ``(nb, k)`` loaded and run. Returns the
        drafts, a device tensor ``[nb, k]``; the lengths advance on the
        host (k a row, capped at the table capacity; idle rows stay 0)."""
        tables = np.zeros((nb, self.max_pages_per_seq), np.int32)
        lengths = np.zeros((nb,), np.int32)
        last = np.zeros((nb,), np.int64)
        for i, s in enumerate(slots):
            tables[i] = self.tables[s]
            lengths[i] = self.lengths[s]
            last[i] = self._last[s]
        with torch.no_grad():
            step = self._graphs.get(("propose", nb, k),
                                    lambda: self._propose_step(nb, k))
            step.load(tables=torch.from_numpy(tables),
                      lengths=torch.from_numpy(lengths),
                      last=torch.from_numpy(last))
            step.run()
            drafts = step.bufs.toks.clone()
        cap = self.max_pages_per_seq * self.page_size
        for i, s in enumerate(slots):
            if lengths[i] > 0:
                self.lengths[s] = min(int(lengths[i]) + k, cap)
        return drafts

    # -------------------------------------------------------- proposal
    def _sync(self, slots, reqs):
        """Reconcile each slot's draft cache with its request's accepted
        history. Returns the catch-up rows ``[(slot, tokens)]``. The cache
        holds the whole context but the last token, whose k/v the propose
        step appends, as the engine's does."""
        rows = []
        for slot, req in zip(slots, reqs):
            hist = _history(req)
            expected = hist.size - 1
            if int(self._slot_rid[slot]) != req.rid:
                self.release(slot)
                self._slot_rid[slot] = req.rid
                pc = self._cache.pcache
                if pc is not None and expected > 0:
                    # a re-prefill splices the cached block-aligned prefix
                    # (matched <= expected, so every write lands past the
                    # shared pages)
                    pages, matched = pc.lookup(hist[:expected])
                    for i, p in enumerate(pages):
                        self.tables[slot, i] = p
                        self._cache.page_ref[p] += 1
                    self.lengths[slot] = matched
            cached = int(self.lengths[slot])
            if cached > expected:
                # roll back the propose rows the verifier rejected
                self.lengths[slot] = expected
                self._cache.trim(slot, self._pages_needed(expected))
                cached = expected
            if cached < expected:
                rows.append((slot, hist[cached:expected]))
            self._last[slot] = hist[-1]
        return rows

    def propose(self, engine, slots, reqs, want, k):
        n = len(slots)
        nb = _pow2ceil(max(n, 1))
        dlen = np.asarray([min(int(w), k) for w in want], np.int32)
        # a slot the draft pool cannot grow is released outright (its
        # propose row idles on the trash page) and drafts nothing: a
        # half-synced cache would leave stale k/v behind the roll-back
        degraded = set()
        rows = []
        for s, d in self._sync(slots, reqs):
            if self._ensure_pages(s, int(self.lengths[s]) + d.size):
                rows.append((s, d))
            else:
                self.release(s)
                degraded.add(s)
        if rows:
            self._catch_up(rows)
        # publish every synced slot's full draft blocks (a no-op without
        # a prefix cache)
        for s, req in zip(slots, reqs):
            if s not in degraded:
                self._cache.register(_history(req)[:int(self.lengths[s])],
                                     self.tables[s])
        for i, s in enumerate(slots):
            if s not in degraded and not self._ensure_pages(
                    s, int(self.lengths[s]) + k):
                self.release(s)
                degraded.add(s)
            if s in degraded:
                dlen[i] = 0
        return self._run_propose(slots, nb, k), dlen
