"""Speculative decoding for the port's paged engine, after
``paddle_tpu/inference/spec``.

Decode is memory-bound: a step streams all weight bytes to emit one token
per sequence, so its cost is nearly flat in how many positions it scores.
A cheap drafter proposes k tokens, ONE verify forward through the paged
path (the verify kernel) scores all k+1 positions, and acceptance keeps
the usable prefix: token-exact argmax matching for greedy requests
(output identical to vanilla decode), rejection sampling for temperature
> 0. Rejected rows roll back through the engine's ``_trim_pages``.

``Engine(model, spec="ngram", spec_k=4)``, or ``Engine(model,
spec="draft", spec_k=4, draft_model=small_lm)``: a small causal LM sharing
the target's vocabulary drafts over its own paged pool
(``DraftModelDrafter``). On a sharded engine (tp/ep > 1) the draft model
runs on rank 0 alone, whole, over its own pool, as the reference's does;
only the verify step rides the sharded weights. A follower rank never
builds the drafter (``FollowerDrafter`` holds its place).
"""
from __future__ import annotations

from .acceptance import accept_tokens
from .controller import AdaptiveDraftController
from .drafter import DraftModelDrafter, FollowerDrafter, NgramDrafter
from .verifier import make_verify_fn

__all__ = ["SpecDecoder", "NgramDrafter", "DraftModelDrafter",
           "FollowerDrafter",
           "AdaptiveDraftController", "accept_tokens", "make_verify_fn"]


class _SpecMetrics:
    """The reference's spec-decode metrics (registered only on a spec
    engine with metrics on), in the port's registry."""

    def __init__(self, drafter_name: str):
        from ...observability import SIZE_BUCKETS, counter, histogram

        self.proposed = counter(
            "paddle_tpu_spec_proposed_total",
            "draft tokens proposed to the verifier",
            labelnames=("drafter",)).labels(drafter=drafter_name)
        self.accepted = counter(
            "paddle_tpu_spec_accepted_total",
            "draft tokens accepted by the verifier",
            labelnames=("drafter",)).labels(drafter=drafter_name)
        self.draft_len = histogram(
            "paddle_tpu_spec_draft_len",
            "drafts proposed per request per verify step",
            buckets=SIZE_BUCKETS)
        self.tokens_per_step = histogram(
            "paddle_tpu_spec_tokens_per_verify_step",
            "tokens landed per request per verify step (1 + accepted)",
            buckets=SIZE_BUCKETS)
        self.drafter_faults = counter(
            "paddle_tpu_spec_drafter_faults_total",
            "drafter proposals that raised (step fell back to zero "
            "drafts — vanilla-equivalent)",
            labelnames=("drafter",)).labels(drafter=drafter_name)


class SpecDecoder:
    """Engine-side spec-decode state: the drafter, the per-request adaptive
    controller and the rolling totals :meth:`stats` reports."""

    def __init__(self, engine, mode: str, k: int = 4, draft_model=None,
                 max_ngram: int = 3, min_ngram: int = 1):
        if mode == "ngram":
            self.drafter = NgramDrafter(max_ngram=max_ngram,
                                        min_ngram=min_ngram)
        elif mode == "draft":
            if draft_model is None:
                raise ValueError(
                    'spec="draft" needs draft_model=<small causal LM '
                    "sharing the target's vocab>")
            DraftModelDrafter.check(draft_model, engine)
            # a sharded engine's draft runs on rank 0 alone, unsharded (as
            # the reference's drafter does): its drafts reach the
            # followers inside the verify command
            self.drafter = DraftModelDrafter(draft_model, engine) \
                if engine.is_leader else FollowerDrafter()
        else:
            raise ValueError(
                f"spec={mode!r}: expected 'ngram' or 'draft' (or "
                "None/'off' for vanilla decode)")
        # the k+1-row verify block must fit the chunk_size headroom that
        # add_request keeps below max_position
        self.k = max(1, min(int(k), engine.chunk_size))
        self.engine = engine
        self.controller = AdaptiveDraftController(self.k)
        self._m = (_SpecMetrics(self.drafter.name)
                   if engine._m is not None else None)
        self.verify_steps = 0      # verify dispatches
        self.request_steps = 0     # per-request verify rows harvested
        self.tokens_landed = 0     # tokens delivered by verify steps
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        self.drafter_faults = 0    # proposals that raised
        self.last_drafter_fault = None  # the last such exception
        self.wall_seconds = 0.0    # _spec_step wall time of the above

    def note(self, req, proposed: int, accepted: int, landed: int):
        """Per-request bookkeeping for one harvested verify row."""
        self.controller.update(req, proposed, accepted)
        self.request_steps += 1
        self.tokens_landed += landed
        self.drafts_proposed += proposed
        self.drafts_accepted += min(accepted, proposed)
        if self._m is not None:
            if proposed:
                self._m.proposed.inc(proposed)
                self._m.accepted.inc(min(accepted, proposed))
            self._m.draft_len.observe(proposed)
            self._m.tokens_per_step.observe(landed)

    def observe_step(self, wall: float):
        self.verify_steps += 1
        self.wall_seconds += wall

    def note_drafter_fault(self, exc: BaseException):
        """The drafter raised ``exc``: the step goes on with zero drafts (a
        vanilla decode step), the exception is kept with its traceback and
        the drafter resets."""
        self.drafter_faults += 1
        self.last_drafter_fault = exc
        self.drafter.reset()
        if self._m is not None:
            self._m.drafter_faults.inc()

    def stats(self) -> dict:
        """Rolling summary: landed tokens per request-row per verify step,
        draft acceptance rate, spec ms per token (host clock)."""
        return {
            "drafter": self.drafter.name,
            "k": self.k,
            "verify_steps": self.verify_steps,
            "tokens_landed": self.tokens_landed,
            "accept_per_step": (
                self.tokens_landed / self.request_steps
                if self.request_steps else 0.0),
            "accept_rate": (
                self.drafts_accepted / self.drafts_proposed
                if self.drafts_proposed else 0.0),
            "drafter_faults": self.drafter_faults,
            "spec_ms_per_token": (
                1e3 * self.wall_seconds / self.tokens_landed
                if self.tokens_landed else 0.0),
        }
