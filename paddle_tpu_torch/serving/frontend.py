"""The serving front end's engine-core loop, after
``paddle_tpu/serving/frontend.py``.

``ServingFrontend`` decouples request arrival from the scheduling loop:

* **One engine thread.** The paged ``Engine`` is not thread-safe, so EVERY
  engine call (``add_request``/``step``/``cancel``) happens on the front
  end's own thread. Submitters only touch the thread-safe
  :class:`~paddle_tpu_torch.serving.fairness.FairQueue` and their own
  :class:`StreamTicket`; the loop drains the queue into the engine, steps
  it and completes tickets. ``Engine.step`` enters ``torch.no_grad()`` and
  the engine's CUDA device itself (both are per thread in PyTorch).
* **Fair admission with concurrency shares.** The loop feeds the engine
  only while it can place work now (free slots beyond the engine's own
  short queue), popping by weighted virtual time and skipping tenants that
  hold their weight-proportional slot share while other tenants wait.
* **Multi-step when idle.** With arrivals queued the loop steps the engine
  one iteration at a time (a freed slot admits the next fair pick at
  once); with the queue idle it hands the engine its full ``multi_step``
  budget (``Engine.step(n)``).
* **Graceful drain.** ``drain(grace_s)`` stops admissions (``QueueFull``
  to new submitters), lets in-flight streams finish inside the grace
  budget, cancels the stragglers through ``Engine.cancel`` and stops the
  engine thread.

``StreamTicket`` is the submitter's handle: a thread-safe token stream
(blocking ``next_chunk``/``result``, or an ``on_chunk`` callback for
asyncio bridging) plus host-side TTFT/TPOT timestamps.

A fault that escapes ``Engine.step`` (the engine recovers what it can, so
this is one the card cannot survive, such as an illegal address) ends the
engine thread: it is kept as :attr:`ServingFrontend.fault`, every live and
queued ticket finishes with reason ``engine``, and ``alive`` turns False.

``poison()`` is the chaos surface of an in-process replica (the router's
``replica-crash`` point, ``InProcReplica.kill``): the engine thread leaves
at its next turn without finishing, cancelling or draining anything, so
its live tickets go silent as a killed process's streams do, and
``alive`` is False at once.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..inference.errors import EngineError, QueueFull
from ..observability import counter
from ..observability.tracing import TRACER as _TRACER
from .fairness import DEFAULT_TENANT, FairQueue

__all__ = ["ServingFrontend", "StreamTicket"]


class StreamTicket:
    """A submitted request's stream handle. Engine-thread side pushes
    token chunks and the terminal state; any thread consumes."""

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 seed: Optional[int], tenant: str,
                 deadline_s: Optional[float],
                 on_chunk: Optional[Callable] = None,
                 resume_tokens: Optional[List[int]] = None,
                 max_buffered: int = 4096,
                 trace: Optional[str] = None,
                 t_origin: Optional[float] = None):
        self.prompt = np.asarray(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = seed
        self.tenant = tenant
        self.deadline_s = deadline_s
        # resume-from-emitted: tokens the stream already delivered
        # elsewhere, passed through to Engine.add_request; only FRESH
        # tokens ever reach this ticket's consumer
        self.resume_tokens = (list(resume_tokens)
                              if resume_tokens else None)
        self.rid: Optional[int] = None
        self.tokens: List[int] = []
        self.done = False
        self.failure_reason: Optional[str] = None
        self.cancelled = False
        self.stall_cancelled = False
        # parent span context (wire string) and the ORIGINAL submit time
        # (TTFT attribution starts there)
        self.trace = trace
        # host-side latency marks (what loadgen reads)
        self.t_submit = time.perf_counter()
        self.t_origin = (float(t_origin) if t_origin is not None
                         else self.t_submit)
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self._chunks: deque = deque()
        self._cond = threading.Condition()
        self._on_chunk = on_chunk
        # slow-client accounting: chunks handed to the consumer side but
        # not yet consumed. Pull consumers ack by popping (next_chunk);
        # push bridges (the SSE writer) call ``ack()`` once the bytes
        # drained to the client. A consumer that stops consuming shows up
        # as pending > 0 with a growing stall clock, and the front end
        # cancels it, freeing the slot and pages it would otherwise pin.
        self.max_buffered = int(max_buffered)
        self._pending = 0
        self._t_oldest: Optional[float] = None

    # ------------------------------------------- engine-thread callbacks
    def _on_tokens(self, toks: List[int]):
        now = time.perf_counter()
        with self._cond:
            if self.t_first is None:
                self.t_first = now
            self.tokens.extend(int(t) for t in toks)
            if self._on_chunk is None:
                # pull surface only: a push bridge would double-buffer
                # every chunk here with no consumer to drain it
                self._chunks.append(list(toks))
            if self._pending == 0:
                self._t_oldest = now
            self._pending += 1
            self._cond.notify_all()
        if self._on_chunk is not None:
            self._on_chunk(list(toks))

    def _finish(self, failure_reason: Optional[str] = None):
        with self._cond:
            if self.done:
                return
            self.done = True
            self.failure_reason = failure_reason
            self.t_done = time.perf_counter()
            self._cond.notify_all()
        if self._on_chunk is not None:
            self._on_chunk(None)  # end-of-stream sentinel

    # --------------------------------------------------- consumer surface
    def ack(self, n: int = 1):
        """Consumer-side progress mark (slow-client watchdog): a push
        bridge calls this after it delivered a chunk (the SSE writer after
        ``drain()``); pull consumers ack implicitly by popping."""
        now = time.perf_counter()
        with self._cond:
            self._pending = max(0, self._pending - int(n))
            self._t_oldest = now if self._pending else None

    def stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds the oldest unconsumed chunk has been waiting (0.0
        when the consumer is keeping up). A backlog past
        ``max_buffered`` reports inf — the bounded-buffer trip wire."""
        with self._cond:
            if self._pending <= 0 or self._t_oldest is None:
                return 0.0
            if self._pending > self.max_buffered:
                return float("inf")
            return (now or time.perf_counter()) - self._t_oldest

    def next_chunk(self, timeout: Optional[float] = None):
        """Block for the next token chunk; None marks end of stream."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._chunks and not self.done:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 or not self._cond.wait(left):
                    raise TimeoutError("no chunk within timeout")
            if self._chunks:
                self._pending = max(0, self._pending - 1)
                self._t_oldest = (time.perf_counter() if self._pending
                                  else None)
                return self._chunks.popleft()
            return None

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream terminates; returns all tokens (check
        ``failure_reason`` for how it ended)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self.done:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 or not self._cond.wait(left):
                    raise TimeoutError("stream did not terminate in time")
            return list(self.tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.t_first is None
                else self.t_first - self.t_submit)

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean inter-token latency over the decode tail."""
        if self.t_first is None or self.t_done is None \
                or len(self.tokens) <= 1:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)


class ServingFrontend:
    """Engine-core loop thread + fair admission; see module docstring."""

    def __init__(self, engine, tenant_weights: Optional[Dict[str, float]]
                 = None, max_queue_per_tenant: int = 256,
                 max_tenants: int = 64, idle_wait_s: float = 0.02,
                 stream_stall_s: Optional[float] = None,
                 max_buffered_chunks: int = 4096,
                 ready_queue_depth: Optional[int] = None):
        self.engine = engine
        self.queue = FairQueue(weights=tenant_weights,
                               max_queue_per_tenant=max_queue_per_tenant,
                               max_tenants=max_tenants)
        self._weights = dict(tenant_weights or {})
        self._idle_wait_s = float(idle_wait_s)
        # slow-client policy: a live ticket whose consumer made no
        # progress for stream_stall_s (or whose unconsumed backlog passed
        # max_buffered_chunks) is cancelled through Engine.cancel, so its
        # slot and pages free at once. None disables the timer (pull
        # consumers that only call result() never ack); the buffer bound
        # always holds.
        self.stream_stall_s = (None if stream_stall_s is None
                               else float(stream_stall_s))
        self.max_buffered_chunks = int(max_buffered_chunks)
        # readiness gate: queued work beyond this depth marks the server
        # not ready
        self.ready_queue_depth = int(
            ready_queue_depth if ready_queue_depth is not None
            else max(8, 4 * engine.max_slots))
        self._live: Dict[int, StreamTicket] = {}  # rid -> ticket
        self._reqs: Dict[int, object] = {}        # rid -> engine Request
        self._cancels: deque = deque()
        self._calls: deque = deque()  # (fn, box): engine-thread errands
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._draining = False
        self._force_cancel = False
        self._poisoned = False
        self._thread: Optional[threading.Thread] = None
        # the exception that ended the engine thread, if one did
        self.fault: Optional[BaseException] = None
        self._m_slow = counter(
            "paddle_tpu_slow_client_cancels_total",
            "streams cancelled because the consumer stalled past the "
            "stream-stall budget or the per-stream chunk buffer bound")

    # ------------------------------------------------------------ control
    def start(self) -> "ServingFrontend":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="paddle-engine-core", daemon=True)
            self._thread.start()
        return self

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def alive(self) -> bool:
        """Liveness: the engine thread is up and not poisoned (the
        supervisor's process-up check of an in-process replica)."""
        return (self._thread is not None and self._thread.is_alive()
                and not self._poisoned)

    def readiness(self) -> Dict:
        """Readiness snapshot, the ``/readyz`` payload. Ready = alive, not
        draining, the engine watchdog below its readiness threshold, and
        the combined queue depth under ``ready_queue_depth``. The fields
        are host ints read without a lock: a racy read is at worst one
        scheduling step stale."""
        eng = self.engine
        wd = eng._watchdog.readiness()
        queued = len(self.queue) + len(eng._queue)
        ready = (self.alive and not self._draining and wd["ready"]
                 and queued <= self.ready_queue_depth)
        out = {"ready": bool(ready), "alive": self.alive,
               "draining": self._draining,
               "watchdog_level": wd["level"],
               "watchdog_mode": wd["mode"],
               "quarantined": bool(wd.get("quarantined", False)),
               "queue_depth": queued,
               "active": len(eng._active),
               "inflight": len(self._live) + queued}
        # placement payload: the chain-hash digests of every cached prefix
        # block, plus the geometry a peer needs. Racy by design like the
        # fields above: the engine thread mutates the cache dict
        # concurrently, so a torn iteration omits the field.
        try:
            pc = eng._pcache
            if pc is not None:
                out["kv_chains"] = [
                    k.hex() for k in list(pc._by_key)
                ][:self.KV_CHAINS_REPORT_MAX]
            out["page_size"] = int(eng.page_size)
            out["eos_id"] = eng.eos_id
        except Exception:  # pragma: no cover - racy dict resize
            pass
        return out

    # bound on the readiness payload's chain-digest report (4096 hex keys,
    # about 128 KiB)
    KV_CHAINS_REPORT_MAX = 4096

    def poison(self):
        """Sudden replica death (the ``replica-crash`` point's in-process
        arm): the engine thread exits at its next loop turn WITHOUT
        finishing, cancelling or draining anything. Live tickets go
        silent, like a killed process's streams; the router's liveness
        probe and stall watchdog are what must notice."""
        self._poisoned = True
        self._wake.set()

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: Optional[int] = None, tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               on_chunk: Optional[Callable] = None,
               resume_tokens: Optional[List[int]] = None,
               trace: Optional[str] = None,
               t_origin: Optional[float] = None) -> StreamTicket:
        """Enqueue a request (any thread). Raises ``QueueFull`` on
        backpressure, while draining, or once the engine thread is gone.
        ``resume_tokens``: see ``Engine.add_request``. ``trace`` and
        ``t_origin`` are the upstream span context and original submit
        time a caller propagates; both default to "this is the origin"."""
        if self._draining or self._stop.is_set() or self._poisoned \
                or self.fault is not None:
            raise QueueFull("server is draining; not accepting requests")
        tenant = tenant or DEFAULT_TENANT
        ticket = StreamTicket(prompt, max_new_tokens, temperature, seed,
                              tenant, deadline_s, on_chunk=on_chunk,
                              resume_tokens=resume_tokens,
                              max_buffered=self.max_buffered_chunks,
                              trace=trace, t_origin=t_origin)
        if _TRACER.enabled:
            _TRACER.instant("frontend.submit", "frontend",
                            parent=ticket.trace, tenant=tenant,
                            prompt_len=int(ticket.prompt.size),
                            resumed=len(resume_tokens or ()))
        # token footprint as fairness cost: a 32k-token prompt charges
        # its tenant's virtual clock accordingly
        cost = float(ticket.prompt.size + ticket.max_new_tokens)
        ticket.tenant = self.queue.submit(ticket, tenant=tenant, cost=cost)
        self._wake.set()
        return ticket

    def call(self, fn: Callable, timeout: float = 10.0):
        """Run ``fn()`` ON the engine thread and block for its result
        (from any OTHER thread). The engine is single-threaded by
        contract, so cross-thread errands marshal through this deque as
        cancels do. Raises whatever ``fn`` raised, or ``TimeoutError``
        when the loop did not get to it in time."""
        if not self.alive:
            raise RuntimeError("engine thread is not running")
        box = {"evt": threading.Event(), "result": None, "exc": None}
        self._calls.append((fn, box))
        self._wake.set()
        if not box["evt"].wait(timeout):
            raise TimeoutError("engine thread did not run the call "
                               f"within {timeout}s")
        if box["exc"] is not None:
            raise box["exc"]
        return box["result"]

    # ------------------------------------------------------- KV handoff
    def export_kv(self, tokens, timeout: float = 10.0) -> Optional[Dict]:
        """The prompt's cached KV pages as a handoff payload
        (``CacheCoordinator.export_handoff``), captured on the engine
        thread through :meth:`call`; None when nothing is cached."""
        return self.call(
            lambda: self.engine._cache.export_handoff(tokens), timeout)

    def import_kv(self, payload, timeout: float = 10.0) -> int:
        """Adopt a handoff payload into this engine's pool
        (``Engine.adopt_kv_pages``, digest-verified) on the engine thread;
        returns the pages adopted (0: the caller recomputes)."""
        return self.call(
            lambda: self.engine.adopt_kv_pages(payload), timeout)

    def cancel(self, ticket: StreamTicket):
        """Cancel a stream (any thread): a queued ticket dies in the
        fair queue; an admitted one goes through ``Engine.cancel`` on
        the engine thread — slot and pages recycle immediately."""
        ticket.cancelled = True
        self._cancels.append(ticket)
        self._wake.set()

    def drain(self, grace_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new work, finish in-flight streams
        within ``grace_s``, cancel stragglers cleanly, stop the engine
        thread. Blocking (call off the event loop); True if every
        stream finished without a forced cancel."""
        self._draining = True
        self._wake.set()
        finished = self._drained.wait(timeout=max(0.0, grace_s))
        if not finished:
            self._force_cancel = True
            self._wake.set()
            self._drained.wait(timeout=10.0)
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        return finished

    def shutdown(self):
        """Immediate stop (tests): cancel everything, join the thread."""
        # an idempotent latch: racing callers all write the same True
        # values and the engine thread only reads them
        if not self._draining:
            self._draining = True
            self._force_cancel = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # ----------------------------------------------------- engine thread
    def _slot_share(self, tenant: str, contenders: List[str]) -> int:
        """Weight-proportional slot share for ``tenant`` among the
        tenants currently contending (queued or holding slots)."""
        total = sum(self.queue.weight_of(t) for t in contenders) or 1.0
        w = self.queue.weight_of(tenant)
        return max(1, int(round(self.engine.max_slots * w / total)))

    def _contenders(self) -> List[str]:
        live_tenants = {t.tenant for t in self._live.values()}
        return sorted(live_tenants | set(self.queue.queued_tenants()))

    def _feed(self):
        """Admit from the fair queue while the engine can place work NOW
        — free slots beyond its own (short) wait queue.

        Concurrency shares: with an explicit tenant-weight map the
        shares are HARD — every configured tenant counts as a contender
        whether or not it has work queued right now, so a batch tenant
        caps at its weight-proportional slot count and the interactive
        tenant's slots stay warm between its arrivals (the weights ARE
        the reservation; a tenant that wants work-conserving behavior
        gets it by not being weighted). Without a weight map the share
        check only binds under live contention (fully work-conserving
        single-tenant/equal-weight behavior)."""
        eng = self.engine
        while len(eng._free_slots) > len(eng._queue):
            if self._weights:
                contenders = sorted(set(self._weights)
                                    | {t.tenant
                                       for t in self._live.values()}
                                    | set(self.queue.queued_tenants()))
            else:
                contenders = self._contenders()
            blocked = []
            if len(contenders) > 1:
                held: Dict[str, int] = {}
                for t in self._live.values():
                    held[t.tenant] = held.get(t.tenant, 0) + 1
                blocked = [t for t in contenders
                           if held.get(t, 0)
                           >= self._slot_share(t, contenders)]
            popped = self.queue.pop(blocked=blocked)
            if popped is None and blocked and not self._weights:
                popped = self.queue.pop()  # work-conserving fallback
            if popped is None:
                break
            ticket, tenant = popped
            ticket.tenant = tenant
            if ticket.cancelled:
                ticket._finish("cancelled")
                continue
            if _TRACER.enabled:
                # retroactive FairQueue-wait span: submit -> this pop
                now = time.perf_counter()
                _TRACER.complete(
                    "frontend.queue", "frontend",
                    time.time() - (now - ticket.t_submit),
                    now - ticket.t_submit, parent=ticket.trace,
                    tenant=tenant)
            try:
                req = eng.add_request(
                    ticket.prompt, ticket.max_new_tokens,
                    on_token=ticket._on_tokens,
                    temperature=ticket.temperature, seed=ticket.seed,
                    deadline_s=ticket.deadline_s, tenant=tenant,
                    resume_tokens=ticket.resume_tokens,
                    trace=ticket.trace, t_submit=ticket.t_origin)
            except EngineError as e:
                ticket._finish(getattr(e, "reason", "engine"))
                continue
            except ValueError:
                ticket._finish("validation")
                continue
            ticket.rid = req.rid
            self._live[req.rid] = ticket
            self._reqs[req.rid] = req

    def _apply_calls(self):
        """Drain cross-thread errands (engine thread): each ``call()``
        runs here, between scheduling steps, so the engine stays
        single-threaded while other threads (the cluster handoff) get
        results back."""
        while self._calls:
            fn, box = self._calls.popleft()
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 - travels to caller
                box["exc"] = e
            box["evt"].set()

    def _apply_cancels(self):
        while self._cancels:
            ticket = self._cancels.popleft()
            if ticket.done:
                continue
            if ticket.rid is not None:
                self.engine.cancel(ticket.rid)
            elif self.queue.remove(ticket):
                ticket._finish("cancelled")
            # else: between pop and add_request — the cancelled flag in
            # _feed catches it

    def _cancel_stalled(self):
        """Slow-client watchdog: cancel live tickets whose consumer
        stopped making progress, stalled past ``stream_stall_s`` or
        backlogged past ``max_buffered_chunks`` (``stalled_for`` reports
        inf for those whatever the timer). ``Engine.cancel`` recycles the
        slot and pages at once."""
        if not self._live:
            return
        now = time.perf_counter()
        for rid, ticket in list(self._live.items()):
            stalled = ticket.stalled_for(now)
            over = (self.stream_stall_s is not None
                    and stalled > self.stream_stall_s)
            if not over and stalled != float("inf"):
                continue
            ticket.stall_cancelled = True
            self.engine.cancel(rid)
            self._m_slow.inc()

    def _complete(self):
        """Finish tickets whose engine request reached a terminal
        state (the engine has no completion callback — harvest only
        streams tokens)."""
        if not self._live:
            return
        done_rids = []
        for rid, ticket in self._live.items():
            req = self._reqs.get(rid)
            if req is None or req.done:
                done_rids.append(rid)
                ticket._finish(req.failure_reason if req is not None
                               else "engine")
        for rid in done_rids:
            self._live.pop(rid, None)
            self._reqs.pop(rid, None)

    def _loop(self):
        eng = self.engine
        try:
            while not self._stop.is_set():
                if self._poisoned:
                    # vanish mid-flight: live tickets stay unfinished on
                    # purpose, the router's failover must react
                    return
                self._apply_cancels()
                self._apply_calls()
                self._cancel_stalled()
                if self._force_cancel:
                    for rid in list(self._live):
                        eng.cancel(rid)
                    while True:
                        popped = self.queue.pop()
                        if popped is None:
                            break
                        popped[0]._finish("cancelled")
                # draining still FEEDS: a ticket accepted into the fair
                # queue is in-flight work the drain must finish (submit
                # is what the drain gate refuses)
                self._feed()
                if eng._queue or eng._active:
                    # arrivals waiting → single iterations for fast slot
                    # turnover; idle queue → the multi-step fast path
                    n = 1 if len(self.queue) else None
                    eng.step(n)
                    self._complete()
                    if eng._watchdog.quarantined:
                        # fail-stop: step() mints nothing more, so
                        # idle-wait instead of spinning
                        eng._cache.shutdown_tier()
                        self._wake.wait(timeout=self._idle_wait_s)
                        self._wake.clear()
                    continue
                self._complete()
                if self._draining and not self._live \
                        and not len(self.queue):
                    self._drained.set()
                    if self._stop.is_set():
                        break
                # idle: sleep until a submit/cancel/drain wakes us
                self._wake.wait(timeout=self._idle_wait_s)
                self._wake.clear()
        except Exception as e:  # noqa: BLE001 - kept and surfaced
            # step() recovers every fault it can; what escapes it (a dead
            # CUDA context) ends the engine thread: the fault (traceback
            # included) is kept for the owner, and every stream ends with
            # reason "engine" instead of hanging
            self.fault = e
            for ticket in list(self._live.values()):
                ticket._finish("engine")
            self._live.clear()
            self._reqs.clear()
            while True:
                popped = self.queue.pop()
                if popped is None:
                    break
                popped[0]._finish("engine")
        finally:
            try:
                eng._cache.shutdown_tier()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            # fail pending cross-thread errands NOW instead of letting
            # their callers ride out the full call() timeout
            while self._calls:
                _fn, box = self._calls.popleft()
                box["exc"] = RuntimeError("engine thread exited")
                box["evt"].set()
            self._drained.set()
