"""Per-request adaptive draft length, after
``paddle_tpu/inference/spec/controller.py``.

A verify block spends target compute on every proposed position whether
or not it lands. One acceptance-rate EMA per request (mixed workloads hold
both predictable and unpredictable streams at once) shrinks the draft
toward 1 when drafts keep being rejected and raises it back toward
``k_max`` on a predictable stretch. The verify step's width stays
``k_max``; only how many of its slots carry real proposals changes.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["AdaptiveDraftController"]


class AdaptiveDraftController:
    def __init__(self, k_max: int, alpha: float = 0.4):
        self.k_max = max(1, int(k_max))
        self.alpha = float(alpha)
        self._ema: Dict[int, float] = {}  # rid -> acceptance-rate EMA

    def draft_len(self, req) -> int:
        """Drafts to propose for ``req`` this verify step."""
        remaining = req.max_new_tokens - len(req.tokens)
        if remaining <= 1:
            return 0  # the bonus token finishes the request
        # optimistic start, then the EMA; never below 1, or a zero-draft
        # steady state could never see acceptance recover
        ema = self._ema.get(req.rid, 1.0)
        want = int(ema * self.k_max + 0.5)
        return max(1, min(self.k_max, want, remaining - 1))

    def update(self, req, proposed: int, accepted: int):
        if proposed <= 0:
            return
        rate = min(accepted, proposed) / proposed
        prev = self._ema.get(req.rid)
        self._ema[req.rid] = (rate if prev is None
                              else (1 - self.alpha) * prev
                              + self.alpha * rate)

    def rate(self, req) -> float:
        return self._ema.get(req.rid, 1.0)

    def forget(self, req):
        self._ema.pop(req.rid, None)
