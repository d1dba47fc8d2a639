"""Continuous-batching serving engine over the paged KV cache, after
``paddle_tpu/inference/engine.py`` reduced to its default configuration
(no prefix cache, no chunked prefill, no speculative decoding, one device,
dense models).

* **Slots + pages.** ``max_slots`` sequence slots share one page pool per
  layer through block tables; a finished request's pages recycle at once.
  Physical page 0 is the trash page idle slots and padding write into.
* **Bucketed admission.** All admissible queued requests prefill in ONE
  forward: rows pad to the fixed ``max_slots`` pow2 bucket, prompts to a
  shared pow2 length bucket capped at ``max_position``. Prefill attention
  is the flash kernel; the prompt's K/V go into the pages.
* **Chained decode.** Decode runs ``k * chunk_size`` steps per dispatch as
  a Python loop over the functional ``PagedCacheState`` (the JAX
  ``lax.scan``), each step one token per active slot through the paged
  decode kernel. Nothing inside the chain waits for the device: tokens,
  lengths, keys and the NaN flag stay on the card until the one fetch at
  the end of the step, which also harvests the admission wave. The depth
  ``k`` maximises useful tokens per chain boundary; stragglers may
  overshoot their budget (the tokens are discarded, the writes land in
  pages the harvest frees, and lengths cap at the table capacity).
* **Active-slot buckets.** A chain runs over the active slots compacted
  into their own pow2 bucket.
* **Sampling.** Per-request ``temperature`` (0 = greedy) with an optional
  engine-level ``top_k``; per-slot threefry keys (``sampling.py``, bit
  for bit ``jax.random``) ride the chain and survive preemption, so a
  sampled stream is exactly the JAX engine's.
* **Pool pressure.** Page reservation shrinks the chain depth, then
  preempts the longest request (recompute: it requeues at the front and
  re-prefills prompt plus generated tokens), then fails a lone request
  that still cannot fit. ``max_retries`` bounds requeues.
* **Per-request faults.** Validation at ``add_request``; a non-finite
  logit row, a raising ``on_token`` callback or an unexpected error while
  harvesting one request fails that request only (``errors.py``).

Left out of the reference (``ROADMAP.md`` queue A lists them): the prefix
cache, chunked prefill, speculative decoding, pre-admission, the host KV
tier, the watchdog and whole-step fault recovery (an exception inside a
dispatch raises out of ``step``), fault injection, integrity audits,
multi-step, metrics and tracing, deadlines and cancellation, tp/ep and MoE.
Passing any of their constructor arguments raises ``TypeError``.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..framework.device import resolve_device, resolve_dtype
from ..ops.cuda.paged_attention import PagedCacheState
from .cache_coord import CacheCoordinator
from .errors import (AdmissionRejected, CallbackError, NumericsError,
                     PoolExhausted, RequestError, RetriesExhausted,
                     StepFault, ValidationError, failure_reason)
from .runner import ModelRunner
from .sampling import advance_sample_key, key_from_seed, select_token

__all__ = ["Engine", "Request"]


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    on_token: Optional[Callable] = None  # streaming callback(list[int])
    temperature: float = 0.0  # 0 → greedy argmax
    seed: Optional[int] = None  # sampling seed (None → rid)
    tokens: List[int] = field(default_factory=list)  # generated tokens
    done: bool = False
    slot: Optional[int] = None
    retries: int = 0                   # recompute re-queues so far
    failure: Optional[BaseException] = None
    failure_reason: Optional[str] = None
    _key: Optional[np.ndarray] = None  # live PRNG key (survives preemption)
    _t_arrival: float = 0.0            # add_request time (host clock)
    _t_first: Optional[float] = None   # first generated-token harvest

    @property
    def failed(self) -> bool:
        return self.failure_reason is not None

    @property
    def state(self) -> str:
        """QUEUED → ACTIVE → FINISHED | FAILED."""
        if self.failed:
            return "FAILED"
        if self.done:
            return "FINISHED"
        if self.slot is not None:
            return "ACTIVE"
        return "QUEUED"


class Engine:
    """Continuous-batching engine; see module docstring."""

    # prior for the cost of a chain boundary (launch + fetch) in units of
    # one chunk's compute; the chain-depth maximiser weighs it against the
    # tokens stragglers would waste
    BOUNDARY_COST_CHUNKS = 8.0

    def __init__(self, model, max_slots=8, num_pages=512, page_size=16,
                 chunk_size=16, eos_id: Optional[int] = None, dtype=None,
                 quantized_cache=False, max_chain=8,
                 top_k: Optional[int] = None, max_retries: int = 8,
                 device=None):
        cfg = model.config
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.dtype = model.dtype if dtype is None else resolve_dtype(dtype)
        if self.dtype != model.dtype:
            raise ValueError(
                f"page dtype {self.dtype} must match the model's "
                f"{model.dtype}: the decode kernel reads pages in q's dtype "
                "(or int8 with quantized_cache=True)")
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.chunk_size = int(chunk_size)
        self.max_chain = max(1, int(max_chain))
        if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k={top_k} must be in [1, vocab_size="
                             f"{cfg.vocab_size}]")
        self.top_k = top_k
        self.eos_id = eos_id
        self.quantized = bool(quantized_cache)
        self.max_pages_per_seq = cfg.max_position // self.page_size
        self.num_pages = int(num_pages)
        self.max_retries = int(max_retries)
        self.runner = ModelRunner(self)
        self._cache = CacheCoordinator(self)
        self._queue: List[Request] = []
        self._active: Dict[int, Request] = {}  # slot -> request
        self._last_tok = np.zeros((self.max_slots,), np.int64)
        self._temps = np.zeros((self.max_slots,), np.float32)
        self._keys = np.zeros((self.max_slots, 2), np.uint32)
        self._next_rid = 0
        self._stall_steps = 0
        self.preemptions = 0

    # ------------------------------------------------ allocator delegation
    @property
    def tables(self):
        return self._cache.tables

    @property
    def lengths(self):
        return self._cache.lengths

    @property
    def _free_pages(self):
        return self._cache.free_pages

    @property
    def _free_slots(self):
        return self._cache.free_slots

    # ------------------------------------------------------------ requests
    def add_request(self, prompt, max_new_tokens, on_token=None,
                    temperature=0.0, seed=None,
                    resume_tokens=None) -> Request:
        """Submit a request. Everything that could make it unservable is
        checked here: malformed input → ``ValidationError``, a sequence the
        pool or table can never hold → ``AdmissionRejected``.

        ``resume_tokens`` are tokens the stream already emitted elsewhere:
        they count against ``max_new_tokens``, are never re-delivered, and
        admission re-prefills prompt plus them; a seeded sampled stream
        replays one key split per emitted token."""
        raw = np.asarray(prompt)
        if raw.dtype.kind not in "iu":
            raise ValidationError(
                f"prompt must be integer token ids, got dtype {raw.dtype}")
        prompt = raw.astype(np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValidationError("empty prompt")
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab_size:
            raise ValidationError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size}); "
                f"got range [{int(prompt.min())}, {int(prompt.max())}]")
        if int(max_new_tokens) <= 0:
            raise ValidationError(
                f"max_new_tokens must be positive, got {max_new_tokens}")
        if float(temperature) < 0.0:
            raise ValidationError(
                f"temperature must be >= 0, got {temperature}")
        # one chunk of headroom below max_position; chain overshoot is
        # bounded by the length cap and the positions() clamp instead
        limit = self.cfg.max_position - self.chunk_size - 1
        if prompt.size + max_new_tokens > limit:
            clamped = max(0, limit - prompt.size)
            if clamped == 0:
                raise ValidationError(
                    f"prompt ({prompt.size}) leaves no room to generate: "
                    f"prompt + generation must stay under max_position - "
                    f"chunk_size ({limit})")
            warnings.warn(
                f"max_new_tokens clamped {max_new_tokens} -> {clamped}: "
                f"prompt ({prompt.size}) + generation must stay under "
                f"max_position - chunk_size ({limit})", RuntimeWarning,
                stacklevel=2)
            max_new_tokens = clamped
        worst = self._pages_needed(prompt.size + max_new_tokens
                                   + self.chunk_size)
        cap = min(self.max_pages_per_seq, self.num_pages - 1)
        if worst > cap:
            raise AdmissionRejected(
                f"request needs up to {worst} pages but the pool/table caps "
                f"at {cap} — grow num_pages or shrink the request")
        resumed: List[int] = []
        if resume_tokens is not None and len(resume_tokens):
            raw_r = np.asarray(resume_tokens)
            if raw_r.dtype.kind not in "iu":
                raise ValidationError(
                    f"resume_tokens must be integer token ids, got dtype "
                    f"{raw_r.dtype}")
            resumed = [int(t) for t in raw_r.reshape(-1)]
            if min(resumed) < 0 or max(resumed) >= self.cfg.vocab_size:
                raise ValidationError(
                    f"resume_tokens must lie in [0, {self.cfg.vocab_size})")
            if len(resumed) >= int(max_new_tokens):
                raise ValidationError(
                    f"resume_tokens ({len(resumed)}) already meet the "
                    f"generation budget ({max_new_tokens})")
            if self.eos_id is not None and self.eos_id in resumed:
                raise ValidationError("resume_tokens contain eos")
            if float(temperature) > 0.0 and seed is None:
                raise ValidationError(
                    "sampled resume needs an explicit seed")
        req = Request(self._next_rid, prompt, int(max_new_tokens), on_token,
                      temperature=float(temperature), seed=seed)
        if resumed:
            req.tokens = resumed
            if req.temperature > 0.0:
                key0 = torch.tensor(key_from_seed(seed), dtype=torch.int64)
                req._key = advance_sample_key(key0, len(resumed)).numpy() \
                    .astype(np.uint32)
        req._t_arrival = time.perf_counter()
        self._next_rid += 1
        self._queue.append(req)
        return req

    def _fail_request(self, req: Request, exc: BaseException):
        """Move ONE request to terminal FAILED and recycle its slot."""
        if req.done:
            return
        req.failure = exc
        req.failure_reason = failure_reason(exc)
        req.done = True
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self._free_slot(req.slot)
            req.slot = None
        if req in self._queue:
            self._queue.remove(req)

    def _note_stall(self):
        """Queued requests, nothing active, nothing admissible: after a
        few steps shed the queue head with ``PoolExhausted``."""
        self._stall_steps += 1
        if self._stall_steps >= 3 and self._queue:
            self._stall_steps = 0
            head = self._queue[0]
            self._fail_request(head, PoolExhausted(
                f"scheduler stalled: page pool too small to admit request "
                f"{head.rid}", rid=head.rid))

    @staticmethod
    def _wrap_step_fault(exc: BaseException, req: Request) -> StepFault:
        err = StepFault(f"{type(exc).__name__}: {exc}", rid=req.rid)
        err.__cause__ = exc
        return err

    # ------------------------------------------------------------ allocator
    def _pages_needed(self, length):
        return (int(length) + self.page_size - 1) // self.page_size

    def _ensure_pages(self, slot, new_len) -> bool:
        need = self._pages_needed(new_len)
        # count actual allocations: chain headroom can exceed
        # pages_needed(length)
        have = int(np.count_nonzero(self.tables[slot]))
        if need > self.max_pages_per_seq:
            raise PoolExhausted(
                f"sequence needs {need} pages but the per-sequence table "
                f"caps at {self.max_pages_per_seq}")
        taken = []
        for i in range(have, need):
            page = self._cache.alloc_page()
            if page is None:
                # roll back: a False return leaves the allocator unchanged
                for j in range(have, have + len(taken)):
                    self.tables[slot, j] = 0
                for pg in reversed(taken):
                    self._cache.release_page(pg)
                return False
            taken.append(page)
            self.tables[slot, i] = page
        return True

    def _trim_pages(self, slot, keep_len):
        """Release a slot's headroom pages beyond ``keep_len``."""
        need = self._pages_needed(keep_len)
        have = int(np.count_nonzero(self.tables[slot]))
        for i in range(have - 1, need - 1, -1):
            self._cache.release_page(int(self.tables[slot, i]))
            self.tables[slot, i] = 0

    def _preempt(self, slot):
        """Evict a running request under pool pressure (recompute policy):
        its pages recycle, it requeues, and re-admission prefills prompt
        plus generated tokens with its live key, so it resumes exactly."""
        req = self._active.pop(slot)
        req._key = self._keys[slot].copy()
        self.preemptions += 1
        self._free_slot(slot)
        req.slot = None
        self._requeue(req)

    def _requeue(self, req):
        """Front-of-queue requeue with a hard retry bound."""
        req.retries += 1
        if req.retries > self.max_retries:
            self._fail_request(req, RetriesExhausted(
                f"request {req.rid} re-queued more than max_retries="
                f"{self.max_retries} times", rid=req.rid))
            return
        self._queue.insert(0, req)

    def _free_slot(self, slot):
        if slot in self._free_slots:
            return  # idempotent: a double free would hand a slot out twice
        for p in self.tables[slot]:
            if p:
                self._cache.release_page(int(p))
        self.tables[slot, :] = 0
        self.lengths[slot] = 0
        self._free_slots.append(slot)

    def _reserve_step_pages(self, k, target_len):
        """Allocate this step's pages for every active slot — shrinking the
        chain depth, then preempting (retry-bounded), then failing the lone
        unservable request — never raising. Returns the depth reserved, or
        0 once nothing is active."""
        while self._active:
            short = failed = False
            for slot in sorted(self._active,
                               key=lambda s: -int(self.lengths[s])):
                req = self._active[slot]
                try:
                    if not self._ensure_pages(slot,
                                              target_len(slot, req, k)):
                        short = True
                        break
                except RequestError as e:
                    self._fail_request(req, e)
                    failed = True
                    break
            if not short and not failed:
                return k
            # roll back every slot's chain headroom before retrying
            for slot in self._active:
                self._trim_pages(slot, int(self.lengths[slot]))
            if failed:
                continue
            if k > 1:
                k = max(1, k // 2)
                continue
            # victim = longest sequence, ties toward the fewest retries
            victims = sorted(self._active,
                             key=lambda s: (-int(self.lengths[s]),
                                            self._active[s].retries))
            if len(victims) <= 1:
                self._fail_request(self._active[victims[0]], PoolExhausted(
                    "KV page pool exhausted with nothing left to preempt",
                    rid=self._active[victims[0]].rid))
                continue
            self._preempt(victims[0])
        return 0

    # ------------------------------------------------------ device programs
    def _states_from(self, tables, lengths, prefill_valid=None):
        c = self._cache
        return [PagedCacheState(c.k_pages[i], c.v_pages[i],
                                c.scale_pages[i], tables, lengths,
                                self.page_size, prefill_valid=prefill_valid)
                for i in range(self.cfg.num_layers)]

    def _select(self, lg, sampling, temps, keys):
        """(next token, keys, non-finite flag) from f32 logits [B, V]."""
        bad = ~torch.isfinite(lg).all(dim=-1)
        greedy = torch.argmax(lg, dim=-1)
        if not sampling:
            return greedy, keys, bad
        tok, keys = select_token(lg, greedy, temps, keys, self.top_k)
        return tok, keys, bad

    def _make_prefill_raw(self, sampling):
        """The bucketed prefill: ids [nb, S] → (first token [nb], keys,
        bad [nb]); the prompt's K/V land in the pages in place."""
        model = self.model

        @torch.no_grad()
        def prefill(ids, valid, tables, lengths, temps, keys):
            states = self._states_from(tables, lengths, prefill_valid=valid)
            logits, _ = model(ids, caches=states)
            rows = torch.arange(ids.shape[0], device=ids.device)
            last = logits[rows, valid.long() - 1].float()
            return self._select(last, sampling, temps, keys)

        return prefill

    def _make_decode_raw(self, k, sampling):
        """The chained decode: ``k * chunk_size`` steps, one token per slot
        each, with no host sync inside. Returns (tokens [nb, steps],
        lengths, keys, bad)."""
        model = self.model
        steps = k * self.chunk_size

        @torch.no_grad()
        def decode_chain(tables, lengths, last_tok, temps, keys):
            bad = torch.zeros(last_tok.shape, dtype=torch.bool,
                              device=last_tok.device)
            toks = []
            last = last_tok
            for _ in range(steps):
                states = self._states_from(tables, lengths)
                logits, new_states = model(last[:, None], caches=states)
                last, keys, b = self._select(logits[:, -1].float(),
                                             sampling, temps, keys)
                bad = bad | b
                lengths = new_states[0].lengths
                toks.append(last)
            return torch.stack(toks, dim=1), lengths, keys, bad

        return decode_chain

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype)

    # ------------------------------------------------------------ scheduling
    @staticmethod
    def _prefix(req):
        """Tokens that must be in the cache before decode continues: the
        prompt plus anything already generated (after a preemption)."""
        if req.tokens:
            return np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
        return req.prompt

    def _admit_dispatch(self):
        """Launch one bucketed prefill for every admissible queued request
        without waiting for it. Returns ``(admits, tok, keys, bad)`` with
        device tensors the step fetches together with its decode chain."""
        admits = []  # (req, slot, prefix)
        while (self._queue and self._free_slots
               and len(self._active) + len(admits) < self.max_slots):
            req = self._queue[0]
            prefix = self._prefix(req)
            need = self._pages_needed(prefix.size + self.chunk_size)
            if need > self._cache.available_pages():
                break  # pool pressure: let running requests drain first
            slot = self._free_slots.pop()
            self._queue.pop(0)
            try:
                got = self._ensure_pages(slot, prefix.size)
            except RequestError as e:
                self._free_slot(slot)
                self._fail_request(req, e)
                continue
            if not got:
                self._free_slot(slot)
                self._queue.insert(0, req)
                break
            admits.append((req, slot, prefix))
        if not admits:
            return [], None, None, None
        tok, new_keys, bad = self._prefill_wave(
            [(req, prefix, self.tables[slot]) for req, slot, prefix
             in admits])
        for req, slot, prefix in admits:
            self.lengths[slot] = prefix.size
            req.slot = slot
            self._active[slot] = req
            self._temps[slot] = req.temperature
            if req._key is not None:
                self._keys[slot] = req._key
        return admits, tok, new_keys, bad

    def _prefill_wave(self, rows):
        """Launch ONE bucketed prefill for ``rows`` of (req, prefix,
        table_row): rows pad to the fixed max_slots pow2 bucket (padding
        rows write one token to the trash page), prompts to a shared pow2
        length capped at max_position."""
        seq_bucket = min(_pow2ceil(max(p.size for _, p, _ in rows)),
                         self.cfg.max_position)
        nb = _pow2ceil(self.max_slots)
        ids = np.zeros((nb, seq_bucket), np.int64)
        valid = np.ones((nb,), np.int32)
        tables = np.zeros((nb, self.max_pages_per_seq), np.int32)
        temps = np.zeros((nb,), np.float32)
        keys = np.zeros((nb, 2), np.int64)
        for i, (req, prefix, table_row) in enumerate(rows):
            ids[i, :prefix.size] = prefix
            valid[i] = prefix.size
            tables[i] = table_row
            temps[i] = req.temperature
            if req._key is None:
                seed = int(req.seed if req.seed is not None else req.rid)
                req._key = np.array(key_from_seed(seed), np.uint32)
            keys[i] = req._key
        prefill = self.runner.get_prefill((nb, seq_bucket),
                                          bool(np.any(temps > 0.0)))
        return prefill(self._dev(ids), self._dev(valid),
                       self._dev(tables), self._dev(np.zeros((nb,),
                                                             np.int32)),
                       self._dev(temps), self._dev(keys))

    def _harvest_admits(self, admits, first, new_keys, bad):
        for i, (req, slot, _prefix) in enumerate(admits):
            try:
                if bad[i]:
                    raise NumericsError(
                        "non-finite logits at prefill", rid=req.rid)
                if req.slot != slot:
                    # preempted between dispatch and harvest: keep the
                    # token (the re-prefill includes it) and the key
                    self._harvest(req, [int(first[i])])
                    req._key = new_keys[i].astype(np.uint32)
                    if req.done and req in self._queue:
                        self._queue.remove(req)
                    continue
                self._keys[slot] = new_keys[i]
                self._harvest(req, [int(first[i])])
                self._last_tok[slot] = int(first[i])
                if req.done:  # single remaining token: finished at prefill
                    del self._active[slot]
                    self._free_slot(slot)
                    req.slot = None
            except RequestError as e:
                self._fail_request(req, e)
            except Exception as e:
                self._fail_request(req, self._wrap_step_fault(e, req))

    def _harvest(self, req, toks) -> int:
        """Append generated tokens, honouring eos and the budget. Returns
        how many were consumed."""
        fresh = []
        for t in toks:
            if req.done or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                break
            req.tokens.append(int(t))
            fresh.append(int(t))
            if self.eos_id is not None and t == self.eos_id:
                req.done = True
            elif len(req.tokens) >= req.max_new_tokens:
                req.done = True
        if fresh and req._t_first is None:
            req._t_first = time.perf_counter()
        if fresh and req.on_token is not None:
            try:
                req.on_token(fresh)
            except Exception as e:
                err = CallbackError(
                    f"on_token raised {type(e).__name__}: {e}", rid=req.rid)
                err.__cause__ = e
                raise err
        return len(fresh)

    def _chain_depth(self):
        """Pow2 chunks to chain before the next fetch, maximising useful
        tokens per (boundary cost + chain length). With an eos and a
        waiting queue the chain ends when the first slot can finish."""
        rem = [req.max_new_tokens - len(req.tokens)
               for req in self._active.values()]
        kmax = self.max_chain
        if self._queue and self.eos_id is not None:
            kmax = min(kmax, max(1, -(-min(rem) // self.chunk_size)))
        best_k, best_u = 1, -1.0
        k = 1
        while k <= kmax:
            useful = sum(min(r, k * self.chunk_size) for r in rem)
            u = useful / (self.BOUNDARY_COST_CHUNKS + k)
            if u > best_u:
                best_k, best_u = k, u
            k *= 2
        return best_k

    def _alloc_len(self, req, k):
        """Page target for a chained slot, capped at the request's budget
        (overshoot writes past it go to recycled or trash pages)."""
        limit = req.prompt.size + req.max_new_tokens + 1
        return min(int(self.lengths[req.slot]) + k * self.chunk_size, limit)

    def _chain_dispatch(self, slots, k, admits, pre_tok, pre_keys):
        """Launch a decode chain over ``slots`` compacted into their pow2
        bucket. Freshly admitted slots take their first token and key from
        the prefill's device outputs, so no host sync happens between the
        two. Returns the chain tuple; never waits."""
        slot_reqs = [self._active[s] for s in slots]
        n = len(slots)
        nb = _pow2ceil(n)
        tables_c = np.zeros((nb, self.max_pages_per_seq), np.int32)
        lengths_c = np.zeros((nb,), np.int32)
        last_c = np.zeros((nb,), np.int64)
        temps_c = np.zeros((nb,), np.float32)
        keys_c = np.zeros((nb, 2), np.int64)
        tables_c[:n] = self.tables[slots]
        lengths_c[:n] = self.lengths[slots]
        last_c[:n] = self._last_tok[slots]
        temps_c[:n] = self._temps[slots]
        keys_c[:n] = self._keys[slots]
        last_in, keys_in = self._dev(last_c), self._dev(keys_c)
        if admits:
            row_of = {s: i for i, s in enumerate(slots)}
            src, dst = [], []
            for i, (_, slot, _p) in enumerate(admits):
                if slot in row_of:  # an admitted-then-preempted row drops
                    src.append(i)
                    dst.append(row_of[slot])
            if src:
                src_t = self._dev(src, torch.int64)
                dst_t = self._dev(dst, torch.int64)
                last_in[dst_t] = pre_tok[src_t]
                keys_in[dst_t] = pre_keys[src_t]
        sampling = bool(np.any(temps_c > 0.0))
        decode = self.runner.get_decode(nb, k, sampling)
        toks, lengths, keys, bad = decode(
            self._dev(tables_c), self._dev(lengths_c), last_in,
            self._dev(temps_c), keys_in)
        return slots, slot_reqs, toks, lengths, keys, bad

    def _chain_harvest(self, slots, slot_reqs, toks, lengths_h, keys_h,
                       bad_h):
        """Host harvest of a decode chain, one isolation domain per
        request."""
        for i, (slot, req) in enumerate(zip(slots, slot_reqs)):
            if req.done and req.slot is None:
                continue  # finished at the prefill harvest; slot freed
            if req.slot != slot:
                continue  # preempted mid-step; the row is garbage
            try:
                if bad_h[i]:
                    raise NumericsError(
                        "non-finite logits in decode chain", rid=req.rid)
                self._harvest(req, toks[i])
                self._last_tok[slot] = int(toks[i, -1])
                self.lengths[slot] = int(lengths_h[i])
                self._keys[slot] = keys_h[i]
                if req.done:
                    del self._active[slot]
                    self._free_slot(slot)
                    req.slot = None
            except RequestError as e:
                self._fail_request(req, e)
            except Exception as e:
                self._fail_request(req, self._wrap_step_fault(e, req))

    def step(self) -> int:
        """One scheduling round trip: launch the admission prefill and the
        decode chain back to back, then fetch both once and harvest.
        Request-scoped faults fail one request; an exception inside a
        dispatch raises. Returns the number of live requests."""
        admits, pre_tok, pre_keys, pre_bad = self._admit_dispatch()
        chain = None
        if self._active:
            self._stall_steps = 0
            k = self._reserve_step_pages(
                self._chain_depth(),
                lambda slot, req, kk: self._alloc_len(req, kk))
            if self._active:
                chain = self._chain_dispatch(sorted(self._active), k,
                                             admits, pre_tok, pre_keys)
        elif self._queue and not admits:
            self._note_stall()
        # ---- the one fetch of the step: prefill and chain together ----
        if admits:
            self._harvest_admits(admits, pre_tok.cpu().numpy(),
                                 pre_keys.cpu().numpy(),
                                 pre_bad.cpu().numpy())
        if chain:
            slots, slot_reqs, toks, lengths, keys, bad = chain
            self._chain_harvest(slots, slot_reqs, toks.cpu().numpy(),
                                lengths.cpu().numpy(), keys.cpu().numpy(),
                                bad.cpu().numpy())
        return len(self._queue) + len(self._active)

    def run(self, requests=None) -> List[Request]:
        """Serve ``requests`` (or whatever is queued) to completion."""
        done = list(requests) if requests else list(self._queue)
        while self.step():
            pass
        return done
