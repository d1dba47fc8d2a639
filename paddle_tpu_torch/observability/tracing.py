"""Request tracing and the crash flight recorder, after
``paddle_tpu/observability/tracing.py`` (a stdlib copy).

A span recorder sized for the serving hot path:

* **Near-zero when off.** Every record site guards on ``TRACER.enabled``
  (one attribute read); ``span()`` returns a shared no-op handle.
* **Bounded when on.** Finished spans land in a ``deque(maxlen=...)``
  ring: one GIL-atomic append per record, a lock only for snapshots.
* **Context crosses boundaries as plain strings.** :class:`SpanContext`
  is ``trace_id``/``span_id`` hex strings with a ``"trace/span"`` wire
  form, so it rides a ticket attribute across threads and an
  ``X-Trace-Context`` header into the HTTP server.
* **Two export paths.** ``GET /debug/trace`` serves a snapshot of the
  ring, and :func:`flight_record` dumps it to a JSONL postmortem on an
  engine step fault or a quarantine.

Record schema (one dict per finished span / instant event)::

    {"name": "engine.step", "cat": "engine", "ph": "X",   # or "i"
     "trace": "8f2c...", "id": "a1", "parent": "9e" | None,
     "ts": <wall-clock s>, "dur": <s, perf_counter-measured>,
     "proc": "main", "tid": 139872, "args": {...}}

``ts`` is ``time.time()`` (comparable across processes); ``dur`` is a
``perf_counter`` difference. Tracing is host-side telemetry: no record
site sits inside a device program.

Pure stdlib.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "SpanContext", "Span", "Tracer", "TRACER",
    "configure_tracing", "get_tracer", "new_trace_id",
    "span", "instant", "complete", "flight_record",
    "ttft_decomposition_summary",
]

# default ring capacity: at ~200 bytes/record this is ~1 MiB resident
# and a few seconds of engine history at decode rates — the "last N
# seconds" a postmortem wants
_RING_CAP = 4096
# cap on automatic flight dumps per process: a crash loop must not
# fill the disk with identical postmortems
_MAX_FLIGHT_DUMPS = 32

# per-process nonce: span/trace ids minted by different processes
# (subprocess replicas) must never collide when their records merge
# into one cross-replica trace
_NONCE = os.urandom(4).hex()
_ids = itertools.count(1)


def new_trace_id() -> str:
    return f"{_NONCE}{next(_ids):08x}"


def _new_span_id() -> str:
    return f"{_NONCE}-{next(_ids):x}"


class SpanContext:
    """The propagatable identity of a span: plain strings, so it
    crosses thread, SSE, and subprocess boundaries without pickling.
    ``encode()``/``decode()`` is the ``"trace_id/span_id"`` wire form
    (the ``X-Trace-Context`` header value)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def encode(self) -> str:
        return f"{self.trace_id}/{self.span_id}"

    @staticmethod
    def decode(wire) -> Optional["SpanContext"]:
        """Parse a wire string (or pass through a SpanContext); None on
        anything malformed — a bad header must never fail a request."""
        if isinstance(wire, SpanContext):
            return wire
        if not wire or not isinstance(wire, str) or "/" not in wire:
            return None
        trace_id, _, span_id = wire.partition("/")
        if not trace_id or not span_id:
            return None
        return SpanContext(trace_id, span_id)

    def __repr__(self):
        return f"SpanContext({self.encode()!r})"


class _NullSpan:
    """The disabled-path handle: every method is a no-op, shared as a
    singleton so ``span()`` costs one attribute check and no
    allocation when tracing is off."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **args):
        pass

    def set(self, **args):
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """An open span. ``end()`` (or context-manager exit) stamps the
    duration and commits the record to the tracer's ring."""

    __slots__ = ("_tracer", "name", "cat", "ctx", "parent_id",
                 "_t0_wall", "_t0", "args", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 ctx: SpanContext, parent_id: Optional[str],
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.ctx = ctx
        self.parent_id = parent_id
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        self.args = args
        self._done = False

    def set(self, **args):
        """Attach/extend args on an open span."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def end(self, **args):
        if self._done:
            return
        self._done = True
        if args:
            self.set(**args)
        self._tracer._commit(
            self.name, self.cat, self.ctx.trace_id, self.ctx.span_id,
            self.parent_id, self._t0_wall,
            time.perf_counter() - self._t0, self.args)
        if self._tracer._open > 0:
            self._tracer._open -= 1

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        self.end()
        return False


class Tracer:
    """Lock-light ring-buffered span/event recorder. One process-global
    instance (``TRACER``); replicas in separate processes each own
    theirs and the exporter merges on the wall clock."""

    def __init__(self, capacity: int = _RING_CAP):
        self.mode = "off"            # off | on | flight-only
        self.enabled = False         # the hot-path guard (mode != off)
        self.live = False            # /debug/trace served (mode == on)
        self.process = "main"        # Chrome-trace pid label
        self.flight_dir: Optional[str] = None
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()      # snapshots/dumps only
        self._open = 0                     # open spans (leak check)
        self._flight_seq = 0
        self._m_spans = None               # lazy registry counter

    # -------------------------------------------------------- configure
    def configure(self, mode: str = "on", process: Optional[str] = None,
                  capacity: Optional[int] = None,
                  flight_dir: Optional[str] = None) -> "Tracer":
        """(Re)configure (also the test-suite reset). ``flight-only``
        records into the ring (so crashes dump postmortems) without
        serving live snapshots."""
        if mode not in ("off", "on", "flight-only"):
            raise ValueError(f"trace mode must be off|on|flight-only, "
                             f"got {mode!r}")
        with self._lock:
            self.mode = mode
            self.enabled = mode != "off"
            self.live = mode == "on"
            if process is not None:
                self.process = str(process)
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = int(capacity)
                self._ring = deque(self._ring, maxlen=self.capacity)
            if flight_dir is not None:
                self.flight_dir = flight_dir
            self._open = 0
        if self.enabled and self._m_spans is None:
            from .metrics import counter

            self._m_spans = counter(
                "paddle_tpu_trace_spans_total",
                "span/event records committed to the trace ring")
        return self

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._open = 0

    @property
    def open_spans(self) -> int:
        return self._open

    # ---------------------------------------------------------- recording
    def start(self, name: str, cat: str = "",
              parent=None, trace_id: Optional[str] = None, **args):
        """Open a span. ``parent`` is a SpanContext (or wire string)
        the new span nests under; with neither parent nor trace_id a
        fresh trace is minted."""
        if not self.enabled:
            return _NULL_SPAN
        pctx = SpanContext.decode(parent) if parent is not None else None
        if pctx is not None:
            tid, pid = pctx.trace_id, pctx.span_id
        else:
            tid, pid = (trace_id or new_trace_id()), None
        self._open += 1
        return Span(self, name, cat, SpanContext(tid, _new_span_id()),
                    pid, args or None)

    def instant(self, name: str, cat: str = "", parent=None, **args):
        """Zero-duration event (harvests, migrations, fault points)."""
        if not self.enabled:
            return
        pctx = SpanContext.decode(parent) if parent is not None else None
        self._commit(name, cat,
                     pctx.trace_id if pctx else new_trace_id(),
                     _new_span_id(),
                     pctx.span_id if pctx else None,
                     time.time(), None, args or None)

    def complete(self, name: str, cat: str, ts_wall: float, dur_s: float,
                 parent=None, **args):
        """Record a span retroactively (start + duration known after the
        fact — e.g. the TTFT decomposition laid out at first harvest)."""
        if not self.enabled:
            return
        pctx = SpanContext.decode(parent) if parent is not None else None
        self._commit(name, cat,
                     pctx.trace_id if pctx else new_trace_id(),
                     _new_span_id(),
                     pctx.span_id if pctx else None,
                     ts_wall, float(dur_s), args or None)

    def _commit(self, name, cat, trace_id, span_id, parent_id,
                ts_wall, dur_s, args):
        rec = {"name": name, "cat": cat,
               "ph": "i" if dur_s is None else "X",
               "trace": trace_id, "id": span_id, "parent": parent_id,
               "ts": ts_wall, "dur": dur_s,
               "proc": self.process, "tid": threading.get_ident()}
        if args:
            rec["args"] = args
        # deque.append with maxlen is a single GIL-atomic op — the
        # scheduler hot path never takes the lock
        self._ring.append(rec)
        if self._m_spans is not None:
            self._m_spans.inc()

    # ------------------------------------------------------------- export
    def snapshot(self) -> List[Dict]:
        """Copy of the ring, oldest first (the /debug/trace payload)."""
        with self._lock:
            return list(self._ring)

    def flight_record(self, reason: str,
                      path: Optional[str] = None) -> Optional[str]:
        """Snapshot the ring to a JSONL postmortem. Returns the file
        path, or None when tracing is off / the dump cap is reached /
        the write fails (a postmortem must never add a second fault to
        the first)."""
        if not self.enabled:
            return None
        with self._lock:
            if path is None and self._flight_seq >= _MAX_FLIGHT_DUMPS:
                return None
            self._flight_seq += 1
            seq = self._flight_seq
            records = list(self._ring)
        if path is None:
            slug = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:64]
            base = self.flight_dir or os.environ.get(
                "PADDLE_TPU_TRACE_DIR") or "."
            path = os.path.join(
                base, f"flight-{slug}-{os.getpid()}-{seq}.jsonl")
        try:
            dirname = os.path.dirname(path)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps({
                    "kind": "flight", "reason": reason,
                    "time": time.time(), "proc": self.process,
                    "records": len(records)}) + "\n")
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
        except OSError:
            return None
        return path


TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER


def configure_tracing(mode: str = "on", process: Optional[str] = None,
                      capacity: Optional[int] = None,
                      flight_dir: Optional[str] = None) -> Tracer:
    return TRACER.configure(mode, process=process, capacity=capacity,
                            flight_dir=flight_dir)


def span(name: str, cat: str = "", parent=None,
         trace_id: Optional[str] = None, **args):
    """Module-level convenience: ``with span("router.place", parent=ctx)
    as s: ...``. Returns the shared no-op handle when tracing is off."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return TRACER.start(name, cat, parent=parent, trace_id=trace_id,
                        **args)


def instant(name: str, cat: str = "", parent=None, **args):
    if TRACER.enabled:
        TRACER.instant(name, cat, parent=parent, **args)


def complete(name: str, cat: str, ts_wall: float, dur_s: float,
             parent=None, **args):
    if TRACER.enabled:
        TRACER.complete(name, cat, ts_wall, dur_s, parent=parent, **args)


def flight_record(reason: str, path: Optional[str] = None
                  ) -> Optional[str]:
    """The crash postmortem hook (watchdog quarantine, engine step-fault
    recovery, router crash detection). No-op when tracing is off; never
    raises."""
    try:
        return TRACER.flight_record(reason, path=path)
    except Exception:  # pragma: no cover - postmortems must not cascade
        return None


def ttft_decomposition_summary() -> Dict[str, float]:
    """Queue/placement/prefill/promote fractions of total TTFT, read
    from the ``paddle_serving_ttft_component_seconds`` histogram (the
    per-run stats line of ``examples/serve_llama_paged_torch.py``)."""
    from .metrics import REGISTRY

    m = REGISTRY.get("paddle_serving_ttft_component_seconds")
    if m is None:
        return {}
    sums: Dict[str, float] = {}
    count = 0
    for key, leaf in m.series():
        comp = dict(m.label_pairs(key)).get("component", "?")
        sums[comp] = sums.get(comp, 0.0) + leaf.sum
        count = max(count, leaf.count)
    total = sum(sums.values())
    if total <= 0.0:
        return {}
    out = {f"{k}_frac": v / total for k, v in sums.items()}
    out["ttft_sum_s"] = total
    out["n"] = float(count)
    return out
