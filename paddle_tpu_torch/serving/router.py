"""Health-gated routing and mid-stream migration over supervised replicas,
after ``paddle_tpu/serving/router.py``.

One engine survives its own faults (``_recover_step_fault``, the
watchdog), but a dead engine thread takes every stream it holds with it.
This module is the replica layer above the serving front end:

* **Supervision.** A monitor thread heartbeats every
  :class:`~paddle_tpu_torch.serving.replica.Replica` (liveness, and the
  ``heartbeat-drop`` / ``replica-crash`` fault points) and restarts dead
  ones with capped exponential backoff (``paddle_tpu_replica_restarts_total``)
  while their streams migrate away.
* **Health-gated routing.** A new stream goes to the least-loaded READY
  replica (readiness is ``/readyz``: not draining, the watchdog below its
  degradation threshold, queue depth in bounds); a live but degraded
  replica keeps its in-flight work and takes nothing new. With nothing
  ready, placement falls back to any live replica, then retries with
  bounded backoff before failing the request with reason ``replica_lost``.
* **Integrity quarantine.** A live replica reporting ``quarantined`` (its
  weight audit caught silent corruption, and the engine has fail-stopped)
  is fenced like a crash, only sooner: the sweep kills it first, then the
  dead-replica machinery migrates its streams (every delivered token
  predates the corruption, so resume-from-emitted stays exact) and
  restarts it, through its factory, with verified weights
  (``paddle_tpu_replica_quarantines_total``).
* **Mid-stream migration, KV-free.** The router records each stream's
  prompt and every emitted token. When its replica dies (a broken
  transport, the SIGKILL signature; a lost heartbeat; a stream stalled
  past ``stall_s``) the stream re-admits on a healthy replica as
  prompt‖emitted through ``Engine.add_request(resume_tokens=...)``: the
  prefix cache absorbs the recompute, only the continuation streams back,
  and the router splices it so the client sees ONE uninterrupted token
  sequence, bit-identical (greedy by construction; seeded sampling through
  the replayed key schedule).
* **Bounded retry and a single hedge.** Every re-placement loop is bounded
  in attempts, with backoff; optionally a stream whose FIRST token is
  slower than ``hedge_ms`` gets ONE duplicate on another replica: the
  first chunk wins and the loser is cancelled.

Metrics: ``paddle_tpu_router_migrations_total``,
``paddle_tpu_replica_restarts_total``, ``paddle_tpu_router_hedges_total``,
``paddle_tpu_router_replicas_ready``, ``paddle_tpu_replica_quarantines_total``
and ``paddle_tpu_request_failures_total{reason="replica_lost"}``, the
reference's names.

Client callbacks fire on replica-owned threads; ``RouterTicket`` does the
locking. Tickets mirror ``StreamTicket``'s surface, so the load generators
drive a Router exactly as they drive a ServingFrontend.

:mod:`~paddle_tpu_torch.serving.cluster` sits on top:
``Router(pools={"prefill": k, "decode": m})`` turns on role pools, the KV
handoff between a request's prefill and decode legs, and prefix-aware
placement. The router keeps supervision, migration and retry; the
coordinator only shapes placements (the role filter, cache scoring, the
prefill leg's one-token budget) and continues clean prefill completions on
the decode pool. Hedging is off in pool mode: a hedge duplicates the FULL
spec, which would put prefill work back on decode replicas.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..observability import counter, gauge
from ..observability.tracing import TRACER as _TRACER
from ..observability.tracing import flight_record as _flight_record
from ..testing.faultinject import FaultPlan
from .replica import Replica, ReplicaStream, StreamSpec

__all__ = ["Router", "RouterTicket", "REPLICA_LOST"]

# the router's failure reason (labels request_failures_total like the
# engine taxonomy's reasons; stable)
REPLICA_LOST = "replica_lost"


class RouterTicket:
    """The client's stream handle across replica deaths: accumulates
    the FULL emitted sequence (pre- and post-migration), forwards fresh
    chunks to ``on_chunk``, and exposes the same result/latency surface
    as :class:`~paddle_tpu_torch.serving.frontend.StreamTicket` so load
    generators drive a router unchanged."""

    def __init__(self, spec: StreamSpec,
                 on_chunk: Optional[Callable] = None):
        self.spec = spec
        self.prompt = spec.prompt
        self.max_new_tokens = spec.max_new_tokens
        self.tokens: List[int] = []
        self.done = False
        self.failure_reason: Optional[str] = None
        self.cancelled = False
        self.migrations = 0
        self.hedged = False
        # cluster phase: None outside pool mode, else
        # "prefill" -> "handoff" -> "decode"; written under _cond (the
        # coordinator's handoff thread and _place both touch it)
        self.phase: Optional[str] = None
        self.replica: Optional[str] = None  # current host replica name
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.last_progress = self.t_submit
        self._on_chunk = on_chunk
        # the trace ROOT span, minted by
        # Router.submit, ended when the ticket reaches a terminal state;
        # every hop (replicas included, via spec.trace) nests under it
        self._root = None
        self._cond = threading.Condition()
        # sources authorized to deliver into this ticket. Before the
        # first chunk several may race (a hedge); the first to deliver
        # becomes _primary and the rest are cancelled. After migration
        # the fresh source is primary immediately (it resumes exactly
        # where the dead one stopped).
        self._srcs: List[ReplicaStream] = []
        self._primary: Optional[ReplicaStream] = None

    # ------------------------------------------------- replica callbacks
    def _deliver(self, src: ReplicaStream, toks: List[int]) -> bool:
        """Accept a chunk from ``src`` if it is (or becomes) the
        primary source; returns losers False so the router can cancel
        them."""
        cancel_losers: List[ReplicaStream] = []
        with self._cond:
            if self.done or src not in self._srcs:
                return False
            if self._primary is None:
                self._primary = src
                cancel_losers = [s for s in self._srcs if s is not src]
                self._srcs = [src]
            elif src is not self._primary:
                return False
            now = time.perf_counter()
            if self.t_first is None:
                self.t_first = now
            self.last_progress = now
            self.tokens.extend(int(t) for t in toks)
            self._cond.notify_all()
        for s in cancel_losers:
            s.cancel()
        if self._on_chunk is not None:
            self._on_chunk(list(toks))
        return True

    def _finish(self, failure_reason: Optional[str] = None):
        with self._cond:
            if self.done:
                return
            self.done = True
            self.failure_reason = failure_reason
            self.t_done = time.perf_counter()
            self._srcs = []
            self._primary = None
            self._cond.notify_all()
            # claim the trace root under the lock every _root write
            # holds; end() runs outside: it may flush an exporter
            root, self._root = self._root, None
        if root is not None:
            root.end(tokens=len(self.tokens),
                     migrations=self.migrations,
                     failure=failure_reason)
        if self._on_chunk is not None:
            self._on_chunk(None)

    # ----------------------------------------------------- migration aid
    def _detach(self, src: ReplicaStream) -> Optional[List[int]]:
        """Remove a (dead) source; returns the emitted-token snapshot
        to resume from when the ticket still needs a new home, None
        when this source wasn't load-bearing (already finished, or a
        raced-out hedge loser)."""
        with self._cond:
            if self.done or src not in self._srcs:
                return None
            self._srcs.remove(src)
            if self._primary is src:
                self._primary = None
            elif self._srcs:
                return None  # a live source remains (hedge partner)
            return list(self.tokens)

    def _attach(self, src: ReplicaStream, primary: bool):
        with self._cond:
            if self.done:
                return
            self._srcs.append(src)
            if primary:
                self._primary = src

    def stalled_s(self, now: Optional[float] = None) -> float:
        with self._cond:
            if self.done:
                return 0.0
            return (now or time.perf_counter()) - self.last_progress

    # --------------------------------------------------- consumer surface
    def result(self, timeout: Optional[float] = None) -> List[int]:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
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
        if self.t_first is None or self.t_done is None \
                or len(self.tokens) <= 1:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)


class Router:
    """See module docstring. ``replicas`` are started (if needed) by
    ``start()``; ``shutdown()`` stops the monitor and (optionally) the
    replicas."""

    def __init__(self, replicas: List[Replica], fault_plan=None,
                 heartbeat_s: float = 0.1,
                 stall_s: Optional[float] = 30.0,
                 hedge_ms: Optional[float] = None,
                 max_place_attempts: int = 5,
                 place_backoff_s: float = 0.05,
                 max_migrations: int = 3,
                 restart_dead: bool = True,
                 restart_backoff_s: float = 0.2,
                 restart_backoff_cap_s: float = 5.0,
                 pools: Optional[Dict[str, int]] = None,
                 replica_factory: Optional[Callable] = None,
                 handoff_budget_s: float = 5.0,
                 autoscale: Optional[Dict] = None):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        self.replicas = list(replicas)
        self._fi = FaultPlan.from_spec(fault_plan)
        self.heartbeat_s = float(heartbeat_s)
        self.stall_s = None if stall_s is None else float(stall_s)
        self.hedge_ms = None if hedge_ms is None else float(hedge_ms)
        self.max_place_attempts = int(max_place_attempts)
        self.place_backoff_s = float(place_backoff_s)
        self.max_migrations = int(max_migrations)
        self.restart_dead = bool(restart_dead)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self._tickets: set = set()
        self._dead: Dict[int, float] = {}   # replica idx -> death time
        self._restarting: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._m_migrations = counter(
            "paddle_tpu_router_migrations_total",
            "in-flight streams migrated to another replica "
            "(resume-from-emitted re-admission)")
        self._m_restarts = counter(
            "paddle_tpu_replica_restarts_total",
            "dead replicas restarted by the router's supervisor")
        self._m_hedges = counter(
            "paddle_tpu_router_hedges_total",
            "TTFT hedges launched (duplicate stream on a second "
            "replica; first chunk wins)")
        self._m_failures = counter(
            "paddle_tpu_request_failures_total",
            "requests moved to terminal FAILED, by taxonomy reason and "
            "tenant", labelnames=("reason", "tenant"))
        self._m_ready = gauge(
            "paddle_tpu_router_replicas_ready",
            "replicas currently passing the readiness gate")
        self._m_quarantines = counter(
            "paddle_tpu_replica_quarantines_total",
            "replicas fenced off after an integrity-audit failure "
            "(weight corruption): streams migrated, replica killed and "
            "supervised-restarted with verified weights")
        # cluster mode: pools turns the coordinator on; without it no
        # path below consults it
        self.cluster = None
        if pools:
            from .cluster import ClusterCoordinator
            self.cluster = ClusterCoordinator(
                self, dict(pools), replica_factory=replica_factory,
                handoff_budget_s=handoff_budget_s, autoscale=autoscale)

    # ------------------------------------------------------------ control
    def start(self) -> "Router":
        for rep in self.replicas:
            if not rep.alive():
                rep.start()
        if self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="paddle-router-monitor",
                daemon=True)
            self._monitor.start()
        return self

    def shutdown(self, stop_replicas: bool = True):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        if stop_replicas:
            for rep in self.replicas:
                try:
                    rep.stop()
                except Exception:
                    pass

    # ------------------------------------------------------------ routing
    def _ready_replicas(self) -> List[Replica]:
        out = []
        for idx, rep in enumerate(self.replicas):
            with self._lock:
                if idx in self._dead:
                    continue
            if self.cluster is not None and self.cluster.is_drained(idx):
                continue
            try:
                if rep.alive() and rep.ready().get("ready"):
                    out.append(rep)
            except Exception:
                continue
        return out

    def _pick(self, exclude=(), role: Optional[str] = None,
              spec: Optional[StreamSpec] = None) -> Optional[Replica]:
        """Least-loaded READY replica, falling back to any live one:
        when every survivor is degraded, routing to a degraded replica
        still beats failing the request. In pool mode ``role`` narrows
        to that pool (an empty/unready pool borrows cross-role —
        availability beats purity) and ``spec`` upgrades the pick to
        the coordinator's prefix-overlap scoring."""
        ready = [r for r in self._ready_replicas() if r not in exclude]
        if self.cluster is not None and role is not None:
            pool = [r for r in ready if self.cluster.role_of(r) == role]
            if pool:
                ready = pool
        if not ready:
            with self._lock:
                dead = set(self._dead)
            ready = [r for i, r in enumerate(self.replicas)
                     if r not in exclude and i not in dead and r.alive()
                     and not (self.cluster is not None
                              and self.cluster.is_drained(i))]
        if not ready:
            return None
        if self.cluster is not None and spec is not None:
            return self.cluster.choose(ready, spec)
        return min(ready, key=lambda r: r.inflight)

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed: Optional[int] = None,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               on_chunk: Optional[Callable] = None) -> RouterTicket:
        """Route a new stream (ServingFrontend-compatible surface).
        Never raises on placement trouble: a ticket that cannot be
        placed after the bounded retry fails attributably with reason
        ``replica_lost``."""
        spec = StreamSpec([int(t) for t in list(prompt)], max_new_tokens,
                          temperature=temperature, seed=seed,
                          tenant=tenant, deadline_s=deadline_s)
        ticket = RouterTicket(spec, on_chunk=on_chunk)
        # the trace root is minted HERE, at the outermost hop; the
        # wire context + origin clock ride the spec through placement,
        # hedges, and migrations, so the whole stream — both replicas
        # of a migrated one — renders as one contiguous trace
        spec.t_origin = ticket.t_submit
        if _TRACER.enabled:
            # under the ticket's condition like every later _root touch
            # (the monitor thread finishes tickets)
            with ticket._cond:
                ticket._root = _TRACER.start(
                    "request", "router", tenant=tenant or "default",
                    prompt_len=len(spec.prompt),
                    max_new_tokens=int(max_new_tokens))
                spec.trace = ticket._root.ctx.encode()
        with self._lock:
            self._tickets.add(ticket)
        self._place(ticket, resume=None, exclude=())
        return ticket

    def cancel(self, ticket: RouterTicket):
        ticket.cancelled = True
        with ticket._cond:
            srcs = list(ticket._srcs)
        for s in srcs:
            s.cancel()
        ticket._finish("cancelled")

    # ---------------------------------------------------------- placement
    def _place(self, ticket: RouterTicket, resume: Optional[List[int]],
               exclude=()):
        """(Re)admit ``ticket`` somewhere healthy: bounded attempts with
        backoff, resume-from-emitted when
        ``resume`` carries the dead replica's delivered tokens."""
        spec = ticket.spec
        sub = StreamSpec(spec.prompt, spec.max_new_tokens,
                         temperature=spec.temperature, seed=spec.seed,
                         tenant=spec.tenant, deadline_s=spec.deadline_s,
                         resume_tokens=resume,
                         # same trace + origin clock on every
                         # (re)placement: a migrated stream's spans on
                         # the new replica join the ORIGINAL trace
                         trace=spec.trace, t_origin=spec.t_origin)
        role = None
        if self.cluster is not None:
            # pool mode: pick the role pool and (for a fresh prompt
            # worth disaggregating) cap the prefill leg to one token
            sub, role = self.cluster.outbound(ticket, sub)
        place = _TRACER.start(
            "router.place", "router", parent=spec.trace,
            resumed=len(resume or ())) if _TRACER.enabled else None
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_place_attempts):
            if ticket.done:
                if place is not None:
                    place.end(outcome="ticket-done", attempts=attempt)
                return
            if attempt:
                # backoff between attempts; the first try is immediate
                # (failover latency is the product here)
                time.sleep(min(1.0, self.place_backoff_s * (2 **
                                                            (attempt - 1))))
            rep = self._pick(exclude=exclude if attempt == 0 else (),
                             role=role, spec=sub)
            if rep is None:
                continue
            # two-phase submit: wire the stream to the ticket BEFORE
            # launching, so a replica fast enough to emit its first
            # chunk immediately can never race the attach and drop it
            stream = rep.prepare(sub, self._on_chunk, self._on_done,
                                 self._on_broken)
            stream._ticket = ticket
            ticket._attach(stream, primary=resume is not None)
            ticket.replica = rep.name
            # fresh stall budget for the new home (a migration storm
            # must not count the dead replica's silence against the
            # live one); under _cond like the delivery-side write
            with ticket._cond:
                ticket.last_progress = time.perf_counter()
            try:
                rep.launch(stream)
            except Exception as e:
                last_exc = e
                stream.cancel()
                ticket._detach(stream)
                continue
            if place is not None:
                place.end(outcome="placed", replica=rep.name,
                          attempts=attempt + 1)
            return
        if place is not None:
            place.end(outcome="failed", attempts=self.max_place_attempts)
        self._fail(ticket, REPLICA_LOST, last_exc)

    def _fail(self, ticket: RouterTicket, reason: str,
              exc: Optional[BaseException] = None):
        del exc  # attributable via logs/metrics only; the slug is the API
        self._m_failures.labels(
            reason=reason, tenant=ticket.spec.tenant or "default").inc()
        with self._lock:
            self._tickets.discard(ticket)
        ticket._finish(reason)

    # ------------------------------------------------- replica callbacks
    def _on_chunk(self, stream: ReplicaStream, toks: List[int]):
        ticket = getattr(stream, "_ticket", None)
        if ticket is not None:
            ticket._deliver(stream, toks)

    def _on_done(self, stream: ReplicaStream,
                 failure_reason: Optional[str]):
        ticket = getattr(stream, "_ticket", None)
        if ticket is None:
            return
        with ticket._cond:
            load_bearing = (stream in ticket._srcs
                            and (ticket._primary is None
                                 or ticket._primary is stream))
        if not load_bearing:
            return  # a cancelled hedge loser reporting in
        if self.cluster is not None:
            if failure_reason is None \
                    and self.cluster.intercept_done(stream, ticket):
                return  # prefill leg done; the handoff continues it
            self.cluster.note_done(ticket)
        with self._lock:
            self._tickets.discard(ticket)
        ticket._finish(failure_reason)

    def _on_broken(self, stream: ReplicaStream, exc: BaseException):
        """Transport died mid-stream (the SIGKILL/poison signature):
        migrate NOW — don't wait for the heartbeat to notice."""
        self._migrate_stream(stream, why=f"broken: {exc}")

    # ---------------------------------------------------------- migration
    def _migrate_stream(self, stream: ReplicaStream, why: str = ""):
        ticket = getattr(stream, "_ticket", None)
        if ticket is None or ticket.done:
            return
        resume = ticket._detach(stream)
        if resume is None:
            return  # not load-bearing (hedge partner still live)
        if ticket.migrations >= self.max_migrations:
            self._fail(ticket, REPLICA_LOST)
            return
        ticket.migrations += 1
        self._m_migrations.inc()
        if _TRACER.enabled:
            _TRACER.instant("router.migrate", "router",
                            parent=ticket.spec.trace,
                            from_replica=stream.replica.name,
                            why=why, emitted=len(resume),
                            migration=ticket.migrations)
        # make sure the old upstream can't keep emitting into a client
        # the new one now owns (harmless for a dead replica, essential
        # for a heartbeat-dropped one that is secretly still alive)
        stream.cancel()
        self._place(ticket, resume=resume,
                    exclude=(stream.replica,))

    def _migrate_replica(self, rep: Replica):
        for stream in rep.streams():
            self._migrate_stream(stream, why="replica dead")

    # --------------------------------------------------------- supervisor
    def _restart(self, idx: int, rep: Replica):
        """Restart a dead replica off the monitor thread (an engine
        rebuild compiles for seconds — the watchdog must keep watching
        the others meanwhile)."""
        delay = min(self.restart_backoff_cap_s,
                    self.restart_backoff_s * (2 ** min(rep.restarts, 8)))
        self._stop.wait(delay)
        try:
            if not self._stop.is_set():
                rep.restart()
                self._m_restarts.inc()
        except Exception:
            pass  # still dead; the next sweep schedules another attempt
        finally:
            with self._lock:
                self._restarting.discard(idx)
                if rep.alive():
                    self._dead.pop(idx, None)

    def _sweep(self):
        """One supervisor tick: fault points, liveness/heartbeat, stream
        stall watchdog, hedging, restart scheduling."""
        now = time.perf_counter()
        ready_count = 0
        for idx, rep in enumerate(self.replicas):
            if self.cluster is not None and self.cluster.is_drained(idx):
                continue  # autoscale-drained: stopped on purpose
            if self._fi is not None and self._fi.fire("replica-crash",
                                                      rid=idx):
                rep.kill()
            up = rep.alive() and rep.heartbeat(self._fi)
            if up:
                # integrity quarantine: a live replica whose weight audit
                # failed
                # is WORSE than a dead one — every token it would still
                # produce flows through corrupt weights. Fence it FIRST
                # (kill — the poison/SIGKILL surface), then let the
                # normal dead-replica machinery below migrate its
                # streams (resume-from-emitted, bit-identical) and
                # schedule the supervised restart, which reloads
                # verified weights through the replica factory.
                try:
                    quarantined = bool(rep.ready().get("quarantined"))
                except Exception:
                    quarantined = False
                if quarantined:
                    self._m_quarantines.inc()
                    if _TRACER.enabled:
                        _TRACER.instant("router.quarantine", "fault",
                                        replica=rep.name)
                        _flight_record(f"replica-quarantine-{rep.name}")
                    rep.kill()
                    up = False
            with self._lock:
                was_dead = idx in self._dead
                if not up and not was_dead:
                    self._dead[idx] = now
                newly_dead = not up and not was_dead
                if up and was_dead and idx not in self._restarting:
                    self._dead.pop(idx, None)
            if newly_dead:
                if _TRACER.enabled:
                    # crash postmortem: for in-process
                    # replicas the shared ring still holds the victim's
                    # last decode steps — dump BEFORE migration churn
                    # overwrites them
                    _TRACER.instant("router.replica_dead", "fault",
                                    replica=rep.name)
                    _flight_record(f"replica-dead-{rep.name}")
                self._migrate_replica(rep)
            if not up and self.restart_dead:
                # (re)schedule the supervised restart: also re-arms
                # when a previous restart attempt itself failed
                with self._lock:
                    schedule = idx not in self._restarting
                    if schedule:
                        self._restarting.add(idx)
                if schedule:
                    threading.Thread(
                        target=self._restart, args=(idx, rep),
                        name=f"replica-restart-{rep.name}",
                        daemon=True).start()
            elif up:
                try:
                    payload = rep.ready()
                    if payload.get("ready"):
                        ready_count += 1
                    if self.cluster is not None:
                        # feed the placement view (kv_chains, geometry,
                        # idle clock) from the same readiness probe
                        self.cluster.observe(rep, payload)
                except Exception:
                    pass
        self._m_ready.set(ready_count)
        if self.cluster is not None:
            self.cluster.autoscale_tick()
        # stream stall watchdog + TTFT hedging
        with self._lock:
            tickets = list(self._tickets)
        for t in tickets:
            if t.done:
                with self._lock:
                    self._tickets.discard(t)
                continue
            stalled = t.stalled_s(now)
            if self.stall_s is not None and stalled > self.stall_s:
                with t._cond:
                    srcs = list(t._srcs)
                for s in srcs:
                    self._migrate_stream(s, why="stalled")
                continue
            if (self.hedge_ms is not None and self.cluster is None
                    and not t.hedged and t.t_first is None
                    and (now - t.t_submit) * 1e3 > self.hedge_ms):
                # hedging is fenced off in pool mode: the duplicate
                # carries the FULL spec, which would re-mix prefill
                # work into decode batches
                self._hedge(t)

    def _hedge(self, ticket: RouterTicket):
        """Single TTFT hedge: one duplicate on a different replica;
        whichever source delivers the first chunk becomes primary and
        the other is cancelled (``RouterTicket._deliver``)."""
        with ticket._cond:
            if ticket.done or ticket._primary is not None \
                    or len(ticket._srcs) != 1:
                return
            current = ticket._srcs[0]
        rep = self._pick(exclude=(current.replica,))
        if rep is None or rep is current.replica:
            return
        ticket.hedged = True
        self._m_hedges.inc()
        if _TRACER.enabled:
            _TRACER.instant("router.hedge", "router",
                            parent=ticket.spec.trace, replica=rep.name)
        stream = rep.prepare(ticket.spec, self._on_chunk,
                             self._on_done, self._on_broken)
        stream._ticket = ticket
        ticket._attach(stream, primary=False)
        try:
            rep.launch(stream)
        except Exception:
            stream.cancel()
            ticket._detach(stream)  # the primary is still in flight

    def _monitor_loop(self):
        while not self._stop.is_set():
            try:
                self._sweep()
            except Exception:
                # the supervisor must outlive anything one sweep hits;
                # a single replica's probe blowing up cannot stop crash
                # detection for the rest
                pass
            self._stop.wait(self.heartbeat_s)
