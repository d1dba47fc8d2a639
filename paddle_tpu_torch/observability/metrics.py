"""Metric primitives and the port's process-global named registry, after
``paddle_tpu/observability/metrics.py`` (a stdlib copy: the port imports
nothing of the JAX package).

The serving engine and its front end record their operational surface
here: TTFT/TPOT histograms, scheduler gauges, failure counters. The
metric names, labels and bucket ladders are the reference's, so one
dashboard reads either package's scrape.

* **Host-side only.** Recording is plain Python on plain floats between
  dispatches, never inside a device program.
* **No locks on the update path.** Under the GIL a ``+=`` on an instance
  attribute can at worst lose a racing increment, which monitoring
  counters tolerate; registration (get-or-create) is locked because it
  mutates shared dicts.
* **Fixed log-spaced buckets.** Latency histograms share one immutable
  ladder (100 us * 2^k), so scrapes aggregate across processes.
* **Ring-buffer timelines.** Gauges and histograms keep a bounded deque of
  recent ``(wall_time, value)`` samples, 1-in-16 decimated (the first
  sample always kept).

Pure stdlib.
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "counter", "gauge", "histogram",
]

# 100 µs .. ~210 s in exact powers of two: log-spaced, fixed across the
# process so every latency histogram is cross-aggregatable.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(22))

# pow2 ladder for batch sizes / occupancy counts (1 .. 4096).
SIZE_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(13))

_TIMELINE_LEN = 240  # recent-sample ring buffer per gauge/histogram
_TIMELINE_EVERY = 16  # 1-in-N timeline decimation (hot-path cost)


class _Metric:
    """Shared naming/label machinery. A metric with ``labelnames`` is a
    parent holding one child per label-value tuple (`.labels(...)`); a
    metric without is itself the single series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._children: Optional[Dict[Tuple[str, ...], "_Metric"]] = (
            {} if self.labelnames else None)
        self._lock = threading.Lock()  # child creation only

    # -- labels --------------------------------------------------------
    def labels(self, **labelvalues) -> "_Metric":
        if self._children is None:
            raise ValueError(
                f"metric {self.name!r} was registered without labels")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def _check_unlabeled(self):
        if self._children is not None:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; "
                "record through .labels(...)")

    def series(self) -> List[Tuple[Tuple[str, ...], "_Metric"]]:
        """[(label_values, leaf_metric)] — ``()`` for the unlabeled case."""
        if self._children is None:
            return [((), self)]
        return sorted(self._children.items())

    def label_pairs(self, key: Tuple[str, ...]) -> List[Tuple[str, str]]:
        return list(zip(self.labelnames, key))

    # -- value reset (tests / between bench phases) --------------------
    def reset(self):
        if self._children is not None:
            self._children.clear()
        self._reset_values()

    def _reset_values(self):
        pass


class Counter(_Metric):
    """Monotonically increasing count (requests, preemptions, retraces)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        self._check_unlabeled()
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def total(self) -> float:
        """Sum across every label series (the scrape-side aggregate)."""
        return sum(leaf._value for _, leaf in self.series())

    def _reset_values(self):
        self._value = 0.0


class Gauge(_Metric):
    """Point-in-time level (pages in use, active slots, queue depth)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._n = 0
        self._timeline = deque(maxlen=_TIMELINE_LEN)

    def set(self, value: float):
        self._check_unlabeled()
        self._value = float(value)
        n = self._n
        self._n = n + 1
        if not n % _TIMELINE_EVERY:
            self._timeline.append((time.time(), self._value))

    def inc(self, amount: float = 1.0):
        self._check_unlabeled()
        self.set(self._value + amount)

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def recent(self) -> List[Tuple[float, float]]:
        """Ring-buffer timeline of the latest ``set`` samples (1-in-16
        decimated)."""
        return list(self._timeline)

    def _reset_values(self):
        self._value = 0.0
        self._n = 0
        self._timeline.clear()


class Histogram(_Metric):
    """Distribution over fixed, immutable bucket upper bounds.

    Prometheus ``le`` semantics: a sample ``v`` lands in the first bucket
    whose bound is ``>= v``; one overflow (+Inf) bucket catches the rest.
    ``percentile`` reads the ladder back (upper-bound estimate — exact
    enough for p50/p99 dashboards at 2x-spaced bounds).
    """

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Iterable[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {self.name!r} needs >=1 bucket")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._timeline = deque(maxlen=_TIMELINE_LEN)

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.bounds)

    def observe(self, value: float):
        self._check_unlabeled()
        value = float(value)
        self._counts[bisect_left(self.bounds, value)] += 1
        self._sum += value
        n = self._count
        self._count = n + 1
        if value > self._max:
            self._max = value
        if not n % _TIMELINE_EVERY:
            self._timeline.append((time.time(), value))

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[int]:
        """Cumulative counts per bound, then the +Inf total — the exact
        series Prometheus exposition emits."""
        out, running = [], 0
        for c in self._counts:
            running += c
            out.append(running)
        return out

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-th percentile (q in [0, 100])."""
        if self._count == 0:
            return 0.0
        target = (q / 100.0) * self._count
        running = 0
        for i, c in enumerate(self._counts[:-1]):
            running += c
            if running >= target:
                return self.bounds[i]
        return self._max  # landed in +Inf: the tracked max is the bound

    def recent(self) -> List[Tuple[float, float]]:
        return list(self._timeline)

    def summary(self) -> Dict[str, float]:
        mean = self._sum / self._count if self._count else 0.0
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": self._max,
        }

    def _reset_values(self):
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._timeline.clear()


class Registry:
    """Named get-or-create metric registry. One process-global instance
    (``REGISTRY``) backs the module-level ``counter/gauge/histogram``
    helpers, so the engine, the compile path, and user code all land in
    the same scrape."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {cls.__name__}")
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames=labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   labelnames=labelnames, buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        """Zero every metric's value, keeping registrations (bench phases,
        tests)."""
        for m in self.collect():
            m.reset()

    def clear(self):
        """Drop every registration (tests only — live code holds metric
        object references that would silently detach from the scrape)."""
        with self._lock:
            self._metrics.clear()

    # -- plain-python snapshot (JSONL sink, bench embedding) -----------
    def snapshot(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for m in self.collect():
            entry: Dict[str, object] = {"type": m.kind, "help": m.help}
            if isinstance(m, Histogram):
                series = {}
                for key, leaf in m.series():
                    series[_label_key(m, key)] = {
                        "buckets": list(leaf.bounds),
                        "cumulative": leaf.cumulative(),
                        **leaf.summary(),
                    }
                entry["series"] = series
            else:
                entry["values"] = {
                    _label_key(m, key): leaf.value
                    for key, leaf in m.series()}
            out[m.name] = entry
        return out


def _label_key(metric: _Metric, key: Tuple[str, ...]) -> str:
    return ",".join(f'{n}="{v}"' for n, v in metric.label_pairs(key))


REGISTRY = Registry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=LATENCY_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)
