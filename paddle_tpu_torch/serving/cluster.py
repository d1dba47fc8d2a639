"""Cluster serving: prefill/decode pools, the KV handoff between replicas
and prefix-cache-aware placement, after ``paddle_tpu/serving/cluster.py``.

The plain router treats N replicas as N interchangeable engines: placement
is by availability (least-loaded READY), every replica prefills AND
decodes, and each replica's prefix cache is an island. This layer above
the router removes both:

* **Role pools.** ``Router(pools={"prefill": k, "decode": m})`` splits the
  replicas: a fresh prompt places on a PREFILL replica with its budget cut
  to one token (prefill and first token: the TTFT unit of work), then
  continues on a DECODE replica through resume-from-emitted. Decode
  batches stay pure decode.
* **KV handoff.** Between the two legs the coordinator ships the prompt's
  KV: the prefill replica exports its cached pages (``export_kv``, a
  gather of whole pages copied to the host, with a blake2b digest a page),
  the payload crosses the replica transport (in-process: the host tensors
  themselves; subprocess: ``POST /v1/kv`` in base64), and the decode
  replica digest-verifies and restores it into its own pool
  (``import_kv`` → ``Engine.adopt_kv_pages``) BEFORE the continuation is
  admitted, whose admission then splices the shipped pages instead of
  recomputing the prompt. Every failure (an export from a killed replica,
  a corrupt page, ``kv-handoff-corrupt``, a slow transfer,
  ``kv-handoff-stall``, pool pressure on the importer) degrades to plain
  resume-from-emitted recompute: a lost shipment costs time, never a
  token. Budget-1 and eos-terminated streams finish on the prefill
  replica.
* **Cache-aware placement.** Replicas report the chain-hash keys of their
  cached prefix blocks in the readiness payload (``kv_chains``); the
  coordinator mirrors them into a view a replica (refreshed each
  supervisor sweep, updated at once on an adoption) and scores candidates
  by OVERLAP DEPTH (the consecutive prompt blocks, from the root, whose
  key the replica holds) before load. A replica that omits the field (an
  older build, a torn racy snapshot) scores 0 and places by availability.
* **Autoscaling.** Queue depth and p99 TTFT drive pool sizes through the
  supervised machinery: an idle replica REASSIGNS its role toward the
  starved pool, a sustained backlog SPAWNS a replica through the caller's
  factory, and surplus idle capacity DRAINS (a graceful stop the
  supervisor then leaves alone); each counts in
  ``paddle_tpu_cluster_rebalances_total``.

Threading: the coordinator's state (roles, views, phase) is under one
lock; a handoff runs on a short-lived thread of its own, because an
in-process prefill leg completes ON the prefill replica's engine thread,
and ``export_kv`` marshals onto that same thread. The coordinator and the
router reach engines only through the replica surface.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference.prefix_cache import chain_keys
from ..observability import counter, gauge
from ..observability.tracing import TRACER as _TRACER
from .replica import Replica, StreamSpec

__all__ = ["ClusterCoordinator", "parse_pools"]


def parse_pools(spec: str) -> Dict[str, int]:
    """Parse a ``prefill=K,decode=M`` pool spec (the
    ``serve_llama_paged_torch.py --pools`` flag's grammar)."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, _, n = part.partition("=")
        role = role.strip()
        if role not in ("prefill", "decode") or not n.strip().isdigit():
            raise ValueError(
                f"bad pool spec {part!r}: expected prefill=K,decode=M")
        out[role] = int(n)
    if not out:
        raise ValueError("empty pool spec")
    return out


class ClusterCoordinator:
    """Pool manager + placement policy above one Router; see module
    docstring. Constructed by ``Router(pools=...)`` — not standalone."""

    def __init__(self, router, pools: Dict[str, int],
                 replica_factory: Optional[Callable] = None,
                 handoff_budget_s: float = 5.0,
                 autoscale: Optional[Dict] = None):
        self.router = router
        self.handoff_budget_s = float(handoff_budget_s)
        self.replica_factory = replica_factory
        knobs = dict(autoscale or {})
        # autoscale knobs:
        self.min_per_role = int(knobs.get("min_per_role", 1))
        self.max_replicas = int(knobs.get("max_replicas",
                                          len(router.replicas) + 2))
        self.queue_high = int(knobs.get("queue_high", 8))
        self.ttft_slo_s = knobs.get("ttft_slo_s")
        self.idle_grace_s = float(knobs.get("idle_grace_s", 30.0))
        self._lock = threading.Lock()
        # role map keyed by replica index into router.replicas; pools
        # assign in order, leftovers default to decode
        self._roles: Dict[int, str] = {}
        want: List[str] = []
        for role in ("prefill", "decode"):
            want += [role] * int(pools.get(role, 0))
        for idx in range(len(router.replicas)):
            self._roles[idx] = (want[idx] if idx < len(want)
                                else "decode")
        self._drained: set = set()          # indices taken out of service
        self._views: Dict[int, set] = {}    # idx -> hex chain-key set
        self._page_size: Optional[int] = None
        self._eos_id: Optional[int] = None
        self._idle_since: Dict[int, float] = {}
        self._ttfts: deque = deque(maxlen=256)  # recent TTFT samples (s)
        self._m_handoffs = counter(
            "paddle_tpu_cluster_handoffs_total",
            "KV handoffs completed prefill -> decode (payload exported, "
            "digest-verified, adopted)")
        self._m_bytes = counter(
            "paddle_tpu_cluster_handoff_bytes_total",
            "KV page bytes shipped across replicas by completed handoffs")
        self._m_fallbacks = counter(
            "paddle_tpu_cluster_fallbacks_total",
            "handoffs degraded to resume-from-emitted recompute (export "
            "failure, digest mismatch, stall past budget, import "
            "pressure)")
        self._m_rebalances = counter(
            "paddle_tpu_cluster_rebalances_total",
            "pool resizes: role reassignments, spawns, and drains")
        self._m_pool = gauge(
            "paddle_tpu_cluster_pool_replicas",
            "replicas currently serving each role (drained excluded)",
            labelnames=("role",))
        self._update_pool_gauges()

    # ------------------------------------------------------------- roles
    def role_of(self, rep: Replica) -> Optional[str]:
        """``rep``'s pool role; None for drained/unknown replicas."""
        reps = self.router.replicas
        with self._lock:
            for idx, r in enumerate(reps):
                if r is rep:
                    return (None if idx in self._drained
                            else self._roles.get(idx, "decode"))
        return None

    def is_drained(self, idx: int) -> bool:
        with self._lock:
            return idx in self._drained

    def pool_sizes(self) -> Dict[str, int]:
        with self._lock:
            out = {"prefill": 0, "decode": 0}
            for idx, role in self._roles.items():
                if idx not in self._drained:
                    out[role] = out.get(role, 0) + 1
            return out

    def _update_pool_gauges(self):
        for role, n in self.pool_sizes().items():
            self._m_pool.labels(role=role).set(n)

    # --------------------------------------------------------- placement
    def outbound(self, ticket, sub: StreamSpec
                 ) -> Tuple[StreamSpec, Optional[str]]:
        """Shape one placement (called by ``Router._place``): decide the
        target ROLE pool and, for a fresh prompt that is worth
        disaggregating, cap the prefill leg's budget to one token (the
        handoff continues it). Resumed placements — cluster
        continuations and ordinary migrations alike — always target the
        decode pool: their prefill is either shipped or absorbed by the
        resume path's recompute."""
        if sub.resume_tokens:
            with ticket._cond:
                ticket.phase = "decode"
            return sub, "decode"
        ps = self._page_size
        worth = (sub.max_new_tokens > 1
                 and self.pool_sizes().get("prefill", 0) > 0
                 and (ps is None or len(sub.prompt) >= ps))
        if not worth:
            # nothing to hand off (one-token budget, or a prompt under
            # one page with no cacheable full block): run it end-to-end
            # on a decode replica
            with ticket._cond:
                ticket.phase = "decode"
            return sub, "decode"
        capped = StreamSpec(sub.prompt, 1,
                            temperature=sub.temperature, seed=sub.seed,
                            tenant=sub.tenant, deadline_s=sub.deadline_s,
                            trace=sub.trace, t_origin=sub.t_origin)
        with ticket._cond:
            ticket.phase = "prefill"
        return capped, "prefill"

    def prompt_keys(self, prompt) -> List[str]:
        """Hex chain keys for ``prompt``'s full blocks — the same
        derivation replicas report in ``kv_chains``, so key equality
        means prefix equality (replica-independently)."""
        ps = self._page_size
        if not ps:
            return []
        return [k.hex() for k in chain_keys(prompt, ps)]

    def choose(self, candidates: List[Replica],
               spec: StreamSpec) -> Replica:
        """Cache-aware pick: score each candidate by overlap depth —
        consecutive prompt blocks from the root whose chain key the
        replica's reported view holds — and take the deepest overlap,
        least-loaded on ties. With no geometry/views yet (old replicas,
        first sweep) every score is 0 and this degenerates to exactly
        the router's least-loaded pick."""
        keys = self.prompt_keys(spec.prompt)
        reps = self.router.replicas
        with self._lock:
            views = {idx: self._views.get(idx, ()) for idx in
                     range(len(reps))}
        def score(rep):
            overlap = 0
            for idx, r in enumerate(reps):
                if r is rep:
                    view = views.get(idx, ())
                    for k in keys:
                        if k not in view:
                            break
                        overlap += 1
                    break
            return (-overlap, rep.inflight)
        return min(candidates, key=score)

    # ------------------------------------------------------- view upkeep
    def observe(self, rep: Replica, payload: Dict):
        """Mirror one readiness payload into the placement view (called
        from the router's supervisor sweep). A payload without
        ``kv_chains`` (older replica / torn snapshot) CLEARS nothing —
        the last good view ages in place and scoring degrades toward
        availability-only, which is the versioning contract."""
        if not isinstance(payload, dict):
            return
        reps = self.router.replicas
        idx = next((i for i, r in enumerate(reps) if r is rep), None)
        if idx is None:
            return
        with self._lock:
            if payload.get("page_size"):
                self._page_size = int(payload["page_size"])
            if payload.get("eos_id") is not None:
                self._eos_id = int(payload["eos_id"])
            chains = payload.get("kv_chains")
            if chains is not None:
                self._views[idx] = set(chains)
            # idle clock for the autoscaler's drain/reassign decisions
            if payload.get("inflight", 1) == 0:
                self._idle_since.setdefault(idx, time.perf_counter())
            else:
                self._idle_since.pop(idx, None)

    def _covers(self, rep: Replica, keys: List[str]) -> bool:
        """Does ``rep``'s reported view already hold every one of the
        prompt's chain keys? (Stale-view optimism is safe: a wrongly
        skipped shipment just recomputes on the decode side.)"""
        reps = self.router.replicas
        idx = next((i for i, r in enumerate(reps) if r is rep), None)
        if idx is None:
            return False
        with self._lock:
            view = self._views.get(idx, set())
        return all(k in view for k in keys)

    def _note_adopted(self, rep: Replica, keys: List[str]):
        """Eager view update after a verified adoption, so the decode
        placement that follows the handoff sees the warm replica NOW
        instead of a sweep later."""
        reps = self.router.replicas
        idx = next((i for i, r in enumerate(reps) if r is rep), None)
        if idx is None:
            return
        with self._lock:
            self._views.setdefault(idx, set()).update(keys)

    # ----------------------------------------------------------- handoff
    def intercept_done(self, stream, ticket) -> bool:
        """Called by ``Router._on_done`` when a stream completes
        cleanly: if it was the PREFILL leg of a pooled placement and
        the request still has budget (and did not stop at eos), detach
        it and continue on the decode pool via the handoff thread.
        Returns True when the ticket's life continues (the router must
        NOT finish it)."""
        with ticket._cond:
            phase = ticket.phase
        if phase != "prefill":
            return False
        emitted = list(ticket.tokens)
        remaining = ticket.spec.max_new_tokens - len(emitted)
        if remaining <= 0 or not emitted:
            return False  # budget was 1 after all: done where it ran
        if self._eos_id is not None and emitted[-1] == self._eos_id:
            # the first token ended the stream; a continuation would be
            # rejected (resume_tokens may not contain eos) — finish here
            return False
        resume = ticket._detach(stream)
        if resume is None:
            return False  # raced with a migration; that path owns it
        with ticket._cond:
            ticket.phase = "handoff"
        threading.Thread(
            target=self._handoff, args=(ticket, stream.replica, resume),
            name=f"cluster-handoff-{stream.replica.name}",
            daemon=True).start()
        return True

    def _handoff(self, ticket, src: Replica, resume: List[int]):
        """The handoff ladder (dedicated thread): export → (chaos) →
        import → re-place on the decode pool with ``resume``. ANY
        failure lands on the same re-place call without the import —
        the decode replica recomputes through resume-from-emitted, which
        gives the same tokens."""
        span = (_TRACER.start("cluster.handoff", "router",
                              parent=ticket.spec.trace, src=src.name)
                if _TRACER.enabled else None)
        t0 = time.perf_counter()
        shipped = False
        fi = self.router._fi
        try:
            if fi is not None and fi.fire("kv-handoff-stall"):
                # slow source/transfer: the sleep lands BEFORE the
                # export, so everything downstream (a replica killed
                # mid-shipment, the budget gate) sees the delay
                time.sleep(fi.param("kv-handoff-stall", "delay_ms", 50.0)
                           / 1e3)
            dst = self.router._pick(exclude=(src,), role="decode",
                                    spec=ticket.spec)
            keys = self.prompt_keys(ticket.spec.prompt)
            if dst is not None and keys and self._covers(dst, keys):
                # an earlier tenant already warmed this decode replica
                # (shared prefix): nothing to ship, nothing degraded
                shipped = True
            elif dst is not None:
                payload = src.export_kv(ticket.spec.prompt)
                if payload and fi is not None \
                        and fi.fire("kv-handoff-corrupt"):
                    self._corrupt_payload(payload, fi)
                if payload and (time.perf_counter() - t0
                                <= self.handoff_budget_s):
                    adopted = dst.import_kv(payload)
                    if adopted > 0:
                        self._note_adopted(dst, keys[:adopted])
                        self._m_handoffs.inc()
                        self._m_bytes.inc(int(payload.get("nbytes", 0)))
                        shipped = True
        except Exception:
            shipped = False  # recompute absorbs every failure mode
        if not shipped:
            self._m_fallbacks.inc()
        if span is not None:
            span.end(shipped=shipped, emitted=len(resume),
                     waited_s=round(time.perf_counter() - t0, 4))
        # decode-side continuation: scoring prefers whichever decode
        # replica now holds the prompt's chain (the one we just fed, or
        # a peer an earlier tenant warmed) — and with nothing shipped
        # this is exactly a migration's re-place
        self.router._place(ticket, resume=resume, exclude=(src,))

    @staticmethod
    def _corrupt_payload(payload: Dict, fi):
        """``kv-handoff-corrupt`` damage: flip one seed-chosen byte of one
        shipped page IN TRANSIT, on a copy of its rows (a page's rows are
        views of the export's host buffers, and the source replica's pool
        stays clean). No doubt signal; only the decode side's digest
        verify stands between this flip and a wrong splice. The draws are
        the reference's, so one plan flips the same byte in both."""
        rows = payload.get("pages") or []
        if not rows:
            return
        j = fi.draw("kv-handoff-corrupt", len(rows))
        rows[j] = [a.clone() if isinstance(a, torch.Tensor) else np.array(a)
                   for a in rows[j]]
        row = rows[j][0]
        if isinstance(row, torch.Tensor):
            flat = row.view(torch.uint8).reshape(-1)
            k = fi.draw("kv-handoff-corrupt", flat.numel())
            flat[k] = flat[k] ^ 0xFF
        else:
            flat = row.view(np.uint8).reshape(-1)
            flat[fi.draw("kv-handoff-corrupt", flat.size)] ^= 0xFF

    def note_done(self, ticket):
        """Terminal-ticket hook (from ``Router._on_done``): feed the
        TTFT sample window the autoscaler reads."""
        if ticket.t_first is not None:
            self._ttfts.append(ticket.t_first - ticket.t_submit)

    # --------------------------------------------------------- autoscale
    def _queue_depth(self, role: str) -> int:
        reps = self.router.replicas
        with self._lock:
            idxs = [i for i, r in self._roles.items()
                    if r == role and i not in self._drained]
        depth = 0
        for i in idxs:
            if i >= len(reps):
                continue
            try:
                depth += int(reps[i].ready().get("queue_depth", 0))
                depth += reps[i].inflight
            except Exception:
                continue
        return depth

    def _p99_ttft_s(self) -> Optional[float]:
        samples = list(self._ttfts)
        if len(samples) < 8:
            return None
        return float(np.percentile(np.asarray(samples), 99))

    def autoscale_tick(self, now: Optional[float] = None):
        """One autoscaler decision (called from the supervisor sweep;
        also directly by tests/benches). At most ONE action per tick —
        resize decisions observe their own effect before the next one:

        1. REASSIGN an idle surplus replica toward a starved pool
           (queue depth past ``queue_high`` while the other pool has
           more than ``min_per_role`` and an idle member).
        2. SPAWN through ``replica_factory`` when BOTH pools are
           backlogged (or p99 TTFT breaches ``ttft_slo_s``) and the
           fleet is under ``max_replicas``.
        3. DRAIN an idle surplus replica (idle past ``idle_grace_s``
           with empty queues) — graceful stop; the supervisor skips
           drained replicas instead of restarting them.
        """
        now = time.perf_counter() if now is None else now
        depth = {role: self._queue_depth(role)
                 for role in ("prefill", "decode")}
        sizes = self.pool_sizes()
        p99 = self._p99_ttft_s()
        slo_breach = (self.ttft_slo_s is not None and p99 is not None
                      and p99 > float(self.ttft_slo_s))
        # 1. role reassignment: starved pool takes an idle donor
        for starved, donor in (("prefill", "decode"),
                               ("decode", "prefill")):
            if depth[starved] < self.queue_high and not (
                    slo_breach and starved == "prefill"):
                continue
            if sizes.get(donor, 0) <= self.min_per_role:
                continue
            idle = self._idle_replica(donor, now, grace=0.0)
            if idle is None:
                continue
            with self._lock:
                self._roles[idle] = starved
                self._idle_since.pop(idle, None)
            self._m_rebalances.inc()
            self._update_pool_gauges()
            if _TRACER.enabled:
                _TRACER.instant("cluster.reassign", "router",
                                replica=self.router.replicas[idle].name,
                                to=starved, depth=depth[starved])
            return
        # 2. spawn: both pools loaded (nothing to borrow) or SLO breach
        total = sum(sizes.values())
        if self.replica_factory is not None and total < self.max_replicas \
                and (min(depth.values()) >= self.queue_high or slo_breach):
            starved = max(depth, key=lambda r: depth[r])
            self._spawn(starved)
            return
        # 3. drain surplus idle capacity
        for role in ("decode", "prefill"):
            if sizes.get(role, 0) <= self.min_per_role \
                    or depth[role] > 0:
                continue
            idle = self._idle_replica(role, now, grace=self.idle_grace_s)
            if idle is None:
                continue
            self._drain(idle)
            return

    def _idle_replica(self, role: str, now: float,
                      grace: float) -> Optional[int]:
        with self._lock:
            for idx, r in self._roles.items():
                if r != role or idx in self._drained:
                    continue
                since = self._idle_since.get(idx)
                if since is None or now - since < grace:
                    continue
                if self.router.replicas[idx].inflight == 0:
                    return idx
        return None

    def _spawn(self, role: str):
        """Grow the fleet by one replica (the caller's factory builds
        and the router's existing machinery supervises it)."""
        try:
            rep = self.replica_factory()
            if not rep.alive():
                rep.start()
        except Exception:
            return  # a failed spawn is a no-op, retried next tick
        self.router.replicas.append(rep)
        idx = len(self.router.replicas) - 1
        with self._lock:
            self._roles[idx] = role
        self._m_rebalances.inc()
        self._update_pool_gauges()
        if _TRACER.enabled:
            _TRACER.instant("cluster.spawn", "router", replica=rep.name,
                            role=role)

    def _drain(self, idx: int):
        """Take one idle replica out of service: mark drained (the
        routing and supervisor paths skip it) and stop it gracefully."""
        rep = self.router.replicas[idx]
        with self._lock:
            self._drained.add(idx)
            self._idle_since.pop(idx, None)
            self._views.pop(idx, None)
        self._m_rebalances.inc()
        self._update_pool_gauges()
        if _TRACER.enabled:
            _TRACER.instant("cluster.drain", "router", replica=rep.name)
        try:
            rep.stop()
        except Exception:
            pass
