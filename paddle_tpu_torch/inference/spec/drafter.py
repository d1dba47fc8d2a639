"""The n-gram drafter for speculative decoding, after ``NgramDrafter`` in
``paddle_tpu/inference/spec/drafter.py``.

``propose(engine, slots, reqs, want, k)`` returns ``(drafts, dlen)``:
``drafts`` a ``[pow2ceil(n), k]`` int32 array in sorted-slot batch order,
``dlen[i] <= k`` the valid proposals of row i. Model-free prompt lookup:
match the request's most recent n-gram earlier in its own prompt and
generation, and propose the tokens that followed. Pure host numpy, no
device work.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NgramDrafter"]


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
