"""Online silent-data-corruption audits of the serving engine, after
``paddle_tpu/inference/integrity.py``.

Silent data corruption changes values without changing control flow: a
flipped bit in device memory, a core that computes wrong, and the engine
keeps streaming tokens that are confidently wrong. The
:class:`IntegritySentinel` closes three windows with host-scheduled
probes that ride the engine's step loop:

* **Weight audits.** At construction the sentinel digests (blake2b) every
  parameter block by block, from the bytes the programs consume
  (``ModelRunner.fetch_param_slice``: the parameters and, for int8/int4
  weights, the quantized buffers and scales of ``nn/quant.py``). A
  periodic probe on an idle step re-fetches one block and compares.
  Weights never change while serving, so a drift is corruption, and its
  containment is quarantine: the watchdog drops readiness and ``step``
  mints nothing more.
* **KV page checksums.** Each cached full block's page gets a checksum
  when it registers; a prefix-cache hit re-verifies the matched pages
  before the splice commits, and a re-registration of an idle page
  re-verifies its stored sum. A mismatch invalidates the entry and its
  descendants, preempts the active slots that reference the page, and the
  admission recomputes: corruption costs a miss, never a token.
* **Shadow recompute.** Every N steps one greedy decode row is re-scored
  through the model's contiguous forward (the flash kernel, an
  independent path from the paged decode kernel), and the delivered token
  is compared with that forward's argmax within ``shadow_tol`` of the
  logit scale. A divergence fails the request with ``IntegrityError``.

Every probe counts in ``paddle_tpu_integrity_checks_total{target}`` and
``paddle_tpu_integrity_failures_total{target}`` (targets ``weights``,
``kv``, ``shadow``, ``sentinel`` for a probe that raised, and ``kv_tier``
/ ``kv_handoff`` for the host tier's and the handoff's digests).

**The page checksum is an exact integer sum** where the reference's is an
f32 one. A page's sum is recorded in a wave of one width and verified in a
wave of another, and on the card a float row reduction may split each row
differently with the wave's width: the same bytes could give two sums.
Here every K, V and scale word of the page, viewed as an integer of its
size (bf16 as int16), is weighted by its position and summed in int64,
wrapping: addition modulo 2^64 has no order, so no reduction order can
change the sum, and a single flipped bit still changes it (the weight of a
word is 1..911 times the buffer's index, far below 2^32).

**A sharded engine** (tp/ep > 1) keeps the reference's global view,
each probe one command that every rank runs (``runner.py``): a page sum
is the wrapping sum of every rank's lane shard, each word weighted at its
position in the whole page, so one all-reduce gives rank 0 the tp=None
sum of the same bytes; a weight block is the reference's range of the
global flat parameter, each rank digests the part it holds (at load, on
its own) and rank 0 learns every rank's verdict; ``bit-flip-weight``
flips its global element on the ranks that hold it; the shadow forward,
which enters the tp all-reduce, runs on every rank.

All of this is host code between dispatches; ``Engine(integrity=None)``
(the default) builds nothing.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .errors import IntegrityError
from .runner import int_words

__all__ = ["IntegrityConfig", "IntegritySentinel", "count_integrity_check",
           "page_checksums"]


def _counter(name: str, help_: str):
    from ..observability import counter

    return counter(name, help_, labelnames=("target",))


def _count_check(target: str, ok: bool, n: int = 1):
    _counter("paddle_tpu_integrity_checks_total",
             "data-integrity verifications performed, by audit target"
             ).labels(target=target).inc(n)
    if not ok:
        _counter("paddle_tpu_integrity_failures_total",
                 "data-integrity verifications that FAILED, by audit "
                 "target").labels(target=target).inc()


def count_integrity_check(target: str, ok: bool, n: int = 1):
    """Record a verification made outside the sentinel (the host tier's
    promote digest, ``kv_tier``; the handoff's, ``kv_handoff``) on the same
    counter pair, sentinel or not."""
    _count_check(target, ok, n)


class IntegrityConfig:
    """The sentinel's knobs. Presets: ``"audit"`` (weight audits and KV
    page checksums) and ``"strict"`` (audit, a tighter weight-audit period
    and the shadow recompute). A dict starts from ``audit`` and overrides
    per key."""

    __slots__ = ("mode", "weight_audit_every", "weight_blocks",
                 "kv_checksums", "shadow_every", "shadow_tol")

    def __init__(self, mode: str = "audit",
                 weight_audit_every: int = 16, weight_blocks: int = 2,
                 kv_checksums: bool = True, shadow_every: int = 0,
                 shadow_tol: float = 0.05):
        self.mode = mode
        self.weight_audit_every = int(weight_audit_every)
        self.weight_blocks = max(1, int(weight_blocks))
        self.kv_checksums = bool(kv_checksums)
        self.shadow_every = int(shadow_every)
        # the tie tolerance, relative to the logit scale: the shadow is an
        # independent numeric path, so near-ties are not divergence
        self.shadow_tol = float(shadow_tol)

    @classmethod
    def coerce(cls, spec) -> Optional["IntegrityConfig"]:
        """``Engine(integrity=...)``: None/"off"/False → no sentinel;
        "audit"/True, "strict" → the preset; a dict → audit with
        overrides; an IntegrityConfig passes through."""
        if spec is None or spec == "off" or spec is False:
            return None
        if isinstance(spec, cls):
            return spec
        if spec == "audit" or spec is True:
            return cls(mode="audit")
        if spec == "strict":
            return cls(mode="strict", weight_audit_every=8,
                       shadow_every=16)
        if isinstance(spec, dict):
            return cls(**{"mode": "audit", **spec})
        raise ValueError(
            f"integrity={spec!r}: expected None/'off'/'audit'/'strict', "
            "an IntegrityConfig, or a dict of its fields")


def page_checksums(pages_flat: List[torch.Tensor], idx: torch.Tensor,
                   lane0: int = 0,
                   lanes: Optional[int] = None) -> torch.Tensor:
    """The exact checksum of every page in ``idx`` (int64, on the pool's
    device): over every buffer ``j`` of ``pages_flat`` (k, v, scale per
    layer), ``(j + 1) * sum(word * (1 + position % 911))`` of the page's
    integer words (``int_words``), wrapping in int64.

    ``lane0`` / ``lanes``: the buffers hold lanes ``[lane0, lane0 + w)``
    of pages ``lanes`` wide (a tp rank's shard); each word is weighted at
    its position in the whole page, so the wrapping sum of every shard's
    checksum is the whole page's."""
    out = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
    for j, b in enumerate(pages_flat):
        sel = int_words(b.index_select(0, idx))
        w = sel.shape[-1]
        rows = torch.arange(sel[0].numel() // w, dtype=torch.int64,
                            device=idx.device)
        pos = rows[:, None] * (w if lanes is None else lanes) + lane0 \
            + torch.arange(w, dtype=torch.int64, device=idx.device)
        weight = 1 + pos.reshape(-1) % 911
        out += (j + 1) * (sel.reshape(idx.shape[0], -1).to(torch.int64)
                          * weight).sum(dim=1)
    return out


class IntegritySentinel:
    """The engine's audit of its weights, KV pages and delivered tokens
    (module docstring). Built last in ``Engine.__init__``: its weight
    baseline digests the weights as loaded."""

    def __init__(self, engine, cfg: IntegrityConfig):
        self.engine = engine
        self.cfg = cfg
        self.last_error: Optional[IntegrityError] = None
        self._steps = 0
        self._since_audit = 0
        self._probe_cursor = 0
        self._shadow_cursor = 0
        self._page_sum: Dict[int, int] = {}
        self.last_margin: Optional[Tuple[float, float]] = None  # shadow
        # per parameter: (element count, [(a, b, digest)])
        self._weight_base: List[Tuple[int, List[Tuple[int, int, str]]]] = []
        self._probe_targets: List[Tuple[int, int]] = []  # (param, block)
        if cfg.weight_audit_every:
            self._snapshot_weights()

    @classmethod
    def build(cls, engine, spec) -> Optional["IntegritySentinel"]:
        cfg = IntegrityConfig.coerce(spec)
        return None if cfg is None else cls(engine, cfg)

    # ------------------------------------------------------- weight audit
    def _param_blocks(self, i: int) -> Tuple[int, List[Tuple[int, int, str]]]:
        """Parameter ``i``'s global element count and its blocks: the
        reference's ranges ``[a, e)`` of the GLOBAL flat parameter, each
        with the digest of the part this rank holds (on a sharded engine
        the part of its shard, ``ModelRunner.local_span``; the whole block
        elsewhere)."""
        runner = self.engine.runner
        host = runner.fetch_param_slice(i, 0, None)
        n = runner.param_numel(i)
        raw = memoryview(host).cast("B")
        item = host.dtype.itemsize
        per = max(1, -(-n // self.cfg.weight_blocks))
        blocks = []
        for a in range(0, n, per):
            e = min(n, a + per)
            lo, hi = runner.local_span(i, a, e)
            blocks.append((a, e, hashlib.blake2b(
                raw[lo * item:hi * item], digest_size=16).hexdigest()))
        return n, blocks

    def _snapshot_weights(self):
        """Digest every parameter block by block (``_param_blocks``). The
        fetches and hashes run on a few threads: both release the
        interpreter lock, and at 7B the baseline is 13.5 GB. Every rank of
        a sharded engine digests its own shard."""
        n = len(self.engine._params)
        with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
            self._weight_base = list(ex.map(self._param_blocks, range(n)))
        for i, (_, bl) in enumerate(self._weight_base):
            self._probe_targets += [(i, b) for b in range(len(bl))]

    def block_ok(self, i: int, b: int) -> bool:
        """Whether this rank's part of block ``b`` of parameter ``i`` still
        matches its load-time digest."""
        a, e, want = self._weight_base[i][1][b]
        lo, hi = self.engine.runner.local_span(i, a, e)
        got = hashlib.blake2b(
            memoryview(self.engine.runner.fetch_param_slice(i, lo, hi))
            .cast("B"), digest_size=16).hexdigest()
        return got == want

    def audit_weights_once(self) -> bool:
        """Probe ONE (param, block) against the load-time digest. A
        mismatch quarantines the engine and returns False. On a sharded
        engine every rank probes its part of the block (one command) and
        a failure on any rank is this probe's."""
        if not self._probe_targets:
            return True
        i, b = self._probe_targets[
            self._probe_cursor % len(self._probe_targets)]
        self._probe_cursor += 1
        a, e, _ = self._weight_base[i][1][b]
        fi = self.engine._fi
        if fi is not None and fi.fire("bit-flip-weight"):
            self._flip_weight_bit(i, a, e, fi)
        runner = self.engine.runner
        bad = runner.audit_weight(i, b)
        ok = not bad
        _count_check("weights", ok)
        if not ok:
            where = f" (rank {', '.join(map(str, bad))}'s shard)" \
                if runner.sharded else ""
            err = IntegrityError(
                f"weight audit digest mismatch: param {i} elements "
                f"[{a}, {e}) no longer match the load-time baseline{where}"
                " — silent weight corruption; quarantining the engine")
            self.last_error = err
            self.engine._watchdog.quarantine(err)
        return ok

    def _flip_weight_bit(self, i: int, a: int, e: int, fi):
        """``bit-flip-weight``'s damage: XOR one seed-chosen bit of one
        seed-chosen element inside the block the probe fetches next,
        written IN PLACE into the tensor the captured graphs read (the
        same draws as the reference, so one seed flips the same bit). The
        element is a global index: on a sharded engine every rank that
        holds it flips it (``ModelRunner.flip_weight``)."""
        flat = a + fi.draw("bit-flip-weight", max(1, e - a))
        bit = fi.draw("bit-flip-weight",
                      8 * self.engine._params[i].element_size())
        self.engine.runner.flip_weight(i, flat, bit)

    # -------------------------------------------------- KV page checksums
    def _page_sums(self, pages: List[int]) -> List[int]:
        return self.engine.runner.page_sums(pages)

    def note_registered(self, pages: List[int]) -> List[int]:
        """Checksum freshly registered pages; a page that already carries
        a sum (an idle block registered again) is re-verified instead.
        Returns the pages that failed (the caller contains them)."""
        if not self.cfg.kv_checksums or not pages:
            return []
        bad: List[int] = []
        for pg, s in zip(pages, self._page_sums([int(p) for p in pages])):
            pg = int(pg)
            old = self._page_sum.get(pg)
            if old is None:
                self._page_sum[pg] = s
                continue
            ok = old == s
            _count_check("kv", ok)
            if not ok:
                bad.append(pg)
        if bad:
            self.last_error = IntegrityError(
                f"KV page checksum mismatch at re-registration: pages "
                f"{bad} changed while parked in the prefix cache")
        return bad

    def verify_pages(self, pages: List[int]) -> List[int]:
        """The splice-time probe: re-sum every matched page that has a
        stored checksum and compare exactly. Returns the bad pages."""
        if not self.cfg.kv_checksums:
            return []
        known = [int(p) for p in pages if int(p) in self._page_sum]
        if not known:
            return []
        bad: List[int] = []
        for pg, s in zip(known, self._page_sums(known)):
            ok = self._page_sum[pg] == s
            _count_check("kv", ok)
            if not ok:
                bad.append(pg)
        if bad:
            self.last_error = IntegrityError(
                f"KV page checksum mismatch at splice: pages {bad} "
                "changed between registration and reuse")
        return bad

    def forget_page(self, page: int):
        """The page left the cache: its sum describes nothing now."""
        self._page_sum.pop(int(page), None)

    def sum_of_page(self, page: int) -> Optional[int]:
        """The stored checksum of ``page`` (None when never registered):
        the host tier reads it at demotion, so it travels with the
        bytes."""
        return self._page_sum.get(int(page))

    def adopt_page_sum(self, page: int, s: int):
        """A promotion restored bytes that matched their demotion digest,
        so the sum recorded before the round trip describes the new page:
        the splice-time probe goes on guarding it."""
        self._page_sum[int(page)] = int(s)

    def reset_kv(self):
        """Pool reset: every checksum over the pool is void."""
        self._page_sum.clear()

    # ---------------------------------------------------- shadow recompute
    @torch.no_grad()
    def shadow_check(self) -> Optional[bool]:
        """Re-score one greedy decode row through the model's contiguous
        forward and compare the delivered last token with its argmax,
        within ``shadow_tol`` of the logit scale. A divergence fails that
        request (``integrity``). None when no row qualifies."""
        eng = self.engine
        cands = [r for r in eng._active.values()
                 if r.temperature == 0.0 and r.tokens and not r.done]
        if not cands:
            return None
        req = cands[self._shadow_cursor % len(cands)]
        self._shadow_cursor += 1
        hist = req.tokens[:-1]
        ids = (np.concatenate([req.prompt, np.asarray(hist, np.int32)])
               if hist else np.asarray(req.prompt, np.int32))
        # a sharded forward enters the tp all-reduce: every rank runs it
        row = eng.runner.shadow(ids).cpu().numpy()
        delivered = int(req.tokens[-1])
        top = float(row.max())
        margin = top - float(row[delivered])
        scale = max(1.0, abs(top))
        self.last_margin = (margin, scale)  # (margin, logit scale)
        ok = margin <= self.cfg.shadow_tol * scale
        _count_check("shadow", ok)
        if not ok:
            err = IntegrityError(
                f"shadow recompute divergence: request {req.rid} "
                f"delivered token {delivered} but the contiguous twin "
                f"argmaxes {int(row.argmax())} (margin {margin:.4f} at "
                f"scale {scale:.4f}) — kernel/SDC divergence",
                rid=req.rid)
            self.last_error = err
            eng._fail_request(req, err)
        return ok

    # ------------------------------------------------------------ driver
    def on_step(self) -> None:
        """The engine's hook after a good step: a weight probe once the
        period has passed on an idle step (or at 4x the period under
        sustained load), a shadow check every ``shadow_every`` steps. A
        probe that raises is recorded as a failed ``sentinel`` check and
        does not fault the step it rides."""
        self._steps += 1
        try:
            cfg = self.cfg
            if cfg.weight_audit_every and \
                    not self.engine._watchdog.quarantined:
                self._since_audit += 1
                idle = not self.engine._queue
                if self._since_audit >= cfg.weight_audit_every and (
                        idle or self._since_audit
                        >= 4 * cfg.weight_audit_every):
                    self._since_audit = 0
                    self.audit_weights_once()
            if cfg.shadow_every and self._steps % cfg.shadow_every == 0:
                self.shadow_check()
        except Exception as e:  # noqa: BLE001 - routed, never dropped
            self._note_probe_fault(e)

    def _note_probe_fault(self, exc: BaseException):
        """A probe broke (not a detection): a failed ``sentinel`` check
        and ``last_error``, so it shows in the scrape."""
        err = IntegrityError(
            f"integrity probe raised {type(exc).__name__}: {exc}")
        err.__cause__ = exc
        self.last_error = err
        _count_check("sentinel", False)
