"""Graceful degradation of the paged serving engine, after
``paddle_tpu/inference/watchdog.py``: a watchdog that counts whole-step
faults, drafter faults and draft-acceptance collapse, and DOWNGRADES the
engine instead of letting it die, then probes its way back up.

Degraded-mode state machine (one axis, monotone levels)::

    0 HEALTHY      spec decode on (if configured), full admission cap
    1 NO_SPEC      spec decode forced off -> vanilla chained decode
                   (greedy output identical by construction)
    2 SMALL_BATCH  admission cap halved on top of NO_SPEC

Transitions DOWN: ``step_fault_threshold`` consecutive whole-step faults
(one level), ``drafter_fault_threshold`` consecutive drafter faults, or a
full acceptance window whose acceptance rate sits below ``accept_floor``
(both to NO_SPEC). Transitions UP: after ``recover_after`` consecutive
healthy steps the level steps back one notch, with the fault counters and
the acceptance window cleared. The level is the
``paddle_tpu_engine_degraded`` gauge (0/1/2); ``paddle_tpu_engine_ready``
is 1 below SMALL_BATCH.

Thread contract: every state-mutating method runs on the engine thread
(the step loop). The only cross-thread surface is read-only:
``ready``/``readiness()`` polled by the HTTP server over GIL-atomic ints
and bools, with ``quarantined`` a monotone latch (False to True once).

**Quarantine** is an orthogonal, sticky axis: once the engine's own state
is proven corrupt, readiness drops at once (``/readyz`` answers 503),
``step`` mints no further token, and nothing probes back up; only a fresh
engine clears it.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

__all__ = ["Watchdog", "HEALTHY", "NO_SPEC", "SMALL_BATCH"]

HEALTHY, NO_SPEC, SMALL_BATCH = 0, 1, 2
_LEVEL_NAMES = {HEALTHY: "healthy", NO_SPEC: "no-spec",
                SMALL_BATCH: "small-batch"}


class Watchdog:
    def __init__(self, engine, step_fault_threshold: int = 3,
                 drafter_fault_threshold: int = 3,
                 accept_floor: float = 0.05, accept_window: int = 32,
                 recover_after: int = 64):
        self.engine = engine
        self.step_fault_threshold = int(step_fault_threshold)
        self.drafter_fault_threshold = int(drafter_fault_threshold)
        self.accept_floor = float(accept_floor)
        self.recover_after = int(recover_after)
        self.level = HEALTHY
        self.quarantined = False           # sticky integrity quarantine
        self.quarantine_cause: Optional[BaseException] = None
        self.last_fault: Optional[BaseException] = None
        self._consec_step_faults = 0
        self._consec_drafter_faults = 0
        self._healthy_steps = 0
        # (proposed, accepted) per spec step; collapse is judged over a
        # FULL window so one unlucky batch can't flap the mode
        self._accept = deque(maxlen=int(accept_window))
        self._apply()

    # ------------------------------------------------------------ events
    def note_step_ok(self):
        """A scheduling step completed without an engine-level fault."""
        self._consec_step_faults = 0
        self._healthy_steps += 1
        if self.level > HEALTHY and self._healthy_steps >= self.recover_after:
            self._recover()

    def note_step_fault(self, exc: BaseException):
        """A whole-step fault (dispatch died / host spine raised)."""
        self.last_fault = exc
        self._healthy_steps = 0
        self._consec_step_faults += 1
        if self._consec_step_faults >= self.step_fault_threshold:
            self._consec_step_faults = 0
            self._degrade()

    def note_drafter_fault(self):
        """The spec drafter raised; the step fell back to zero drafts."""
        self._healthy_steps = 0
        self._consec_drafter_faults += 1
        if self._consec_drafter_faults >= self.drafter_fault_threshold:
            self._consec_drafter_faults = 0
            if self.level < NO_SPEC:
                self.level = NO_SPEC
                self._apply()

    def note_drafter_ok(self):
        self._consec_drafter_faults = 0

    def note_acceptance(self, proposed: int, accepted: int):
        """One spec step's batch-wide draft acceptance. A full window
        under ``accept_floor`` means drafting burns a dispatch per step
        for nothing — degrade to vanilla, recover-probe later."""
        if proposed <= 0:
            return
        self._accept.append((proposed, accepted))
        if len(self._accept) < self._accept.maxlen:
            return
        prop = sum(p for p, _ in self._accept)
        acc = sum(a for _, a in self._accept)
        if prop > 0 and acc / prop < self.accept_floor \
                and self.level < NO_SPEC:
            self._accept.clear()
            self.level = NO_SPEC
            self._apply()

    def quarantine(self, cause: Optional[BaseException] = None):
        """The engine's state is proven corrupt: drop readiness NOW and
        stay down. Sticky by design (see the module docstring); a fresh
        engine's watchdog starts clean."""
        self.quarantined = True
        self.quarantine_cause = cause
        self.last_fault = cause if cause is not None else self.last_fault
        # quarantine is fail-stop: dump the trace ring's postmortem while
        # it still shows the steps that led here (no-op when tracing is
        # off)
        from ..observability.tracing import flight_record

        flight_record("quarantine-"
                      + (type(cause).__name__ if cause else "manual"))
        self._apply()

    # ----------------------------------------------------- state machine
    def _degrade(self):
        if self.level < SMALL_BATCH:
            self.level += 1
            self._apply()

    def _recover(self):
        self.level -= 1
        self._healthy_steps = 0
        self._consec_step_faults = 0
        self._consec_drafter_faults = 0
        self._accept.clear()
        self._apply()

    # ------------------------------------------------------- readiness
    @property
    def ready(self) -> bool:
        """Readiness for NEW traffic: NO_SPEC still serves at full
        admission capacity (drafting off costs throughput, not
        correctness), so it stays ready; SMALL_BATCH means the engine is
        shedding load. A quarantined engine is never ready."""
        return not self.quarantined and self.level < SMALL_BATCH

    def readiness(self) -> dict:
        """The structured readiness snapshot ``/readyz`` serves."""
        return {"ready": self.ready, "level": self.level,
                "mode": self.mode, "quarantined": self.quarantined}

    def _apply(self):
        eng = self.engine
        eng._spec_enabled = self.level < NO_SPEC
        cap = (eng.max_slots if self.level < SMALL_BATCH
               else max(1, eng.max_slots // 2))
        eng._slot_cap = cap
        if eng._m is not None:
            eng._m.degraded.set(self.level)
            eng._m.ready.set(1 if self.ready else 0)

    @property
    def mode(self) -> str:
        return "quarantined" if self.quarantined \
            else _LEVEL_NAMES[self.level]
