"""Deterministic, seed-driven fault injection for the serving engine and
the trainer, after ``paddle_tpu/testing/faultinject.py``: the same points,
the same spec grammar and the same firing rules, so every spec string the
reference accepts parses here and fires at the same checks.

The engine carries NAMED injection points: host-side hook sites the
scheduler consults between dispatches. A plan is a spec string plus a
seed; firing decisions come from per-point check counters and a
counter-keyed PCG64 stream (never wall clock, never global RNG state), so
a chaos test that fails replays identically under the same spec.

Injection points the port's engine fires (``inference/engine.py``,
``inference/cache_coord.py``):

* ``pool-exhaustion``  — ``_ensure_pages`` pretends the page pool is empty
  when a real allocation would happen, driving the shrink-chain → preempt
  → bounded-retry path.
* ``step-exception``   — raises ``InjectedFault`` inside ONE request's
  harvest block (admission, pre-admission, mixed step, decode chain, spec
  verify), proving isolation: the request fails, the batch lives.
* ``nan-logits``       — forces the request's non-finite logit flag, as if
  the model had produced non-finite logits for that row.
* ``drafter-corruption`` — the spec-decode drafter raises (default) or its
  proposed tokens are corrupted (``corrupt=1``), driving the zero-draft
  fallback / rejection machinery.
* ``slow-step``        — sleeps ``delay_ms`` at the top of ``step()``,
  driving deadline expiry deterministically.
* ``prefix-cache-corruption`` — overwrites one cached page's layer-0 K
  rows at a prefix-cache hit (when the page is idle) and signals doubt:
  the cache invalidates the page and every descendant block, and the
  admission recomputes from scratch — a cache miss, never a wrong token.
* ``bit-flip-kv``      — the same damage at a hit WITHOUT the doubt
  signal: only the integrity sentinel's page checksums catch it.

Points fired elsewhere: ``bit-flip-weight`` (the integrity sentinel's
weight audit), ``kv-spill-corrupt``, ``slow-host-copy`` and
``racey-worker-write`` (the host KV tier's worker), ``replica-crash`` (the
router's supervisor sweep, ``rid`` = replica index), ``heartbeat-drop``
(``Replica.heartbeat``), ``kv-handoff-corrupt`` and ``kv-handoff-stall``
(the cluster coordinator's handoff thread).

The training and checkpoint points: ``ckpt-io-error`` (before each file
the checkpoint writer writes), ``slow-ckpt-write`` (before its first
write) and ``bit-flip-ckpt`` (a staged file, after its digest) fire in
``distributed/checkpoint.py``'s writer, driven by the plan that
``distributed/ckpt_manager.py``'s ``CheckpointManager`` (or
``save_state_dict(fault_plan=)``) gives it; ``train-step-exception``
(before each attempt of a step), ``train-nan-loss`` (a step's loss) and
``preempt-signal`` (a step's end) fire in ``hapi/model.py``'s
``Model.fit``.

Spec grammar (``FLAGS_fault_inject`` / env ``PADDLE_TPU_FAULT_INJECT`` /
``Engine(fault_plan=...)``)::

    point[:key=val[,key=val...]][;point2[:...]]

    nan-logits:rid=2,times=1
    pool-exhaustion:at=3,times=2;slow-step:every=1,delay_ms=30
    step-exception:rate=0.01,seed=7

Per-point keys — all optional, combined with AND semantics:

* ``rid=N``      — only checks on behalf of request id N are eligible.
* ``at=N``       — fire exactly on the N-th eligible check (1-based).
* ``every=N``    — fire on every N-th eligible check.
* ``rate=P``     — fire with probability P per eligible check, from the
  plan's seeded stream (deterministic given the check order).
* ``times=M``    — stop firing after M fires (unbounded if absent).
* ``seed=S``     — per-point seed override (default: plan seed).
* ``delay_ms=F`` — slow-step sleep duration (default 20 ms).
* ``corrupt=1``  — drafter-corruption corrupts proposed tokens instead of
  raising.

With none of ``at``/``every``/``rate`` given, the point fires on every
eligible check.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np

__all__ = ["POINTS", "FaultPlan", "InjectedFault", "plan_from_flags"]

POINTS = (
    "pool-exhaustion",
    "step-exception",
    "nan-logits",
    "drafter-corruption",
    "slow-step",
    "prefix-cache-corruption",
    # training-resilience points (checkpoint writer, train loop)
    "ckpt-io-error",
    "train-step-exception",
    "train-nan-loss",
    "preempt-signal",
    "slow-ckpt-write",
    # multi-replica serving points (the router's supervisor loop and
    # Replica.heartbeat)
    "replica-crash",
    "heartbeat-drop",
    # silent-data-corruption points: unlike prefix-cache-corruption
    # nothing signals doubt, so only integrity checks can catch them
    "bit-flip-weight",
    "bit-flip-kv",
    "bit-flip-ckpt",
    # KV host-tier points (the spill worker thread)
    "kv-spill-corrupt",
    "slow-host-copy",
    # thread-ownership point (the spill worker thread)
    "racey-worker-write",
    # cluster KV-handoff points (the cluster's handoff thread)
    "kv-handoff-corrupt",
    "kv-handoff-stall",
)


class InjectedFault(RuntimeError):
    """The exception injected at ``step-exception`` / ``drafter-corruption``
    sites — a deliberately FOREIGN type (not a taxonomy error), so chaos
    tests prove the engine's broad wrap-into-taxonomy path, not just its
    handling of its own exception classes."""


class _Point:
    """One injection point's config + deterministic firing state."""

    __slots__ = ("name", "params", "checks", "fires", "_rng")

    def __init__(self, name: str, params: Dict[str, float], seed: int):
        self.name = name
        self.params = params
        self.checks = 0  # eligible checks seen
        self.fires = 0   # times actually fired
        # counter-keyed stream: (plan-or-point seed) x crc32(point name)
        # — stable across processes, independent across points
        pseed = int(params.get("seed", seed))
        self._rng = np.random.Generator(
            np.random.PCG64([pseed, zlib.crc32(name.encode())]))

    def fire(self, rid: Optional[int]) -> bool:
        p = self.params
        want_rid = p.get("rid")
        if want_rid is not None and (rid is None or int(want_rid) != rid):
            return False
        self.checks += 1
        if "times" in p and self.fires >= int(p["times"]):
            return False
        hit = True
        if "at" in p:
            hit = hit and self.checks == int(p["at"])
        if "every" in p:
            hit = hit and self.checks % int(p["every"]) == 0
        if "rate" in p:
            # draw unconditionally so the stream position depends only on
            # the check index, never on which other keys matched
            draw = float(self._rng.random())
            hit = hit and draw < float(p["rate"])
        if hit:
            self.fires += 1
        return hit


class FaultPlan:
    """A parsed fault-injection plan. The engine calls ``fire(point, rid)``
    at each hook site; everything else is introspection for tests."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._points: Dict[str, _Point] = {}
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            name, _, rest = clause.partition(":")
            name = name.strip()
            if name not in POINTS:
                raise ValueError(
                    f"unknown fault-injection point {name!r}; expected one "
                    f"of {', '.join(POINTS)}")
            params: Dict[str, float] = {}
            for kv in filter(None, (s.strip() for s in rest.split(","))):
                k, _, v = kv.partition("=")
                if not _:
                    raise ValueError(
                        f"malformed fault-injection param {kv!r} "
                        f"(expected key=value)")
                params[k.strip()] = float(v)
            self._points[name] = _Point(name, params, self.seed)

    @classmethod
    def from_spec(cls, spec, seed: int = 0) -> Optional["FaultPlan"]:
        """Coerce ``None`` / empty string / an existing plan / a spec
        string into a plan (or None). The engine's single entry point."""
        if spec is None or isinstance(spec, FaultPlan):
            return spec
        spec = str(spec).strip()
        return cls(spec, seed=seed) if spec else None

    def fire(self, point: str, rid: Optional[int] = None) -> bool:
        """Should ``point`` fault on this check? Deterministic in the
        sequence of calls; counts fires for ``fired()`` and the
        ``paddle_tpu_faults_injected_total{point}`` counter.

        A name outside the :data:`POINTS` registry RAISES: a typo'd
        point in a hook site or a chaos test would otherwise return False
        forever, and the test would assert "no fault fired" against an
        injection that never existed. Valid points simply absent from
        this plan return False."""
        if point not in POINTS:
            raise ValueError(
                f"unregistered fault-injection point {point!r}; known "
                f"points: {', '.join(POINTS)} (add new points to "
                "testing.faultinject.POINTS so typos can never pass "
                "chaos tests vacuously)")
        st = self._points.get(point)
        if st is None:
            return False
        hit = st.fire(rid)
        if hit:
            self._count(point)
        return hit

    def draw(self, point: str, n: int) -> int:
        """A deterministic draw in ``[0, n)`` from ``point``'s seeded
        stream — the bit-flip family's offset/bit selector. Advances the
        same PCG64 stream ``rate=`` uses, so the choice is reproducible
        given the spec+seed and the sequence of calls."""
        if point not in POINTS:
            raise ValueError(
                f"unregistered fault-injection point {point!r}")
        st = self._points.get(point)
        if st is None or n <= 0:
            return 0
        return int(st._rng.integers(0, n))

    def param(self, point: str, key: str, default: float) -> float:
        st = self._points.get(point)
        if st is None:
            return default
        return float(st.params.get(key, default))

    def fired(self, point: str) -> int:
        st = self._points.get(point)
        return st.fires if st is not None else 0

    def active(self, point: str) -> bool:
        return point in self._points

    @staticmethod
    def _count(point: str):
        # observability is optional here: the harness keeps working
        # where the registry cannot be imported
        try:
            from ..observability import counter
        except Exception:  # pragma: no cover - import-cycle safety net
            return
        counter("paddle_tpu_faults_injected_total",
                "fault-injection hook fires, by injection point",
                labelnames=("point",)).labels(point=point).inc()


def plan_from_flags() -> Optional[FaultPlan]:
    """The engine's default plan: ``FLAGS_fault_inject`` (which the env
    var ``PADDLE_TPU_FAULT_INJECT`` overrides at first read, per the
    flags registry contract)."""
    from ..framework import flags

    spec = flags.get_flags("FLAGS_fault_inject")["FLAGS_fault_inject"]
    return FaultPlan.from_spec(spec)
