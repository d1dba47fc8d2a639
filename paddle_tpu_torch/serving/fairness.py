"""Weighted-fair multi-tenant request queue, after
``paddle_tpu/serving/fairness.py``.

The engine's own wait queue is FIFO: correct for one tenant,
starvation-prone for many. This queue sits in front of the engine and
decides whose request the engine sees next:

* **Stride scheduling** (weighted virtual time): each tenant carries a
  virtual clock; ``pop`` serves the tenant with the smallest clock and
  advances it by ``cost / weight``, the cost being the request's token
  footprint (prompt + budget). An idle tenant's clock is clamped to the
  global clock on arrival, so sleeping never banks credit.
* **Per-tenant admission bounds**: a bounded per-tenant backlog
  (``QueueFull``, which the HTTP server maps to 429) and a concurrency
  share (``pop(blocked=...)`` skips tenants already holding their slot
  share while others wait).

Tenant cardinality is bounded (``max_tenants``): past the cap, new tenant
names share the ``"other"`` bucket.

Pure stdlib.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..inference.errors import QueueFull

__all__ = ["DEFAULT_TENANT", "FairQueue", "parse_tenant_weights"]

DEFAULT_TENANT = "default"
OVERFLOW_TENANT = "other"


def parse_tenant_weights(spec: Optional[str]) -> Optional[Dict[str, float]]:
    """Parse the CLI grammar ``"interactive=4,batch=1"`` into a weight
    map (None/empty → None: every tenant shares the default weight)."""
    if not spec:
        return None
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition("=")
        if not name or not w:
            raise ValueError(
                f"tenant weight {part!r} must be name=weight")
        weight = float(w)
        if weight <= 0:
            raise ValueError(f"tenant {name!r} weight must be > 0")
        out[name.strip()] = weight
    return out or None


class _Tenant:
    __slots__ = ("name", "weight", "vtime", "items")

    def __init__(self, name: str, weight: float, vtime: float):
        self.name = name
        self.weight = weight
        self.vtime = vtime
        self.items: deque = deque()


class FairQueue:
    """Thread-safe weighted-fair queue of opaque items keyed by tenant.

    ``submit`` enqueues (bounded per tenant, ``QueueFull`` on overflow);
    ``pop`` dequeues by smallest virtual time, optionally skipping
    ``blocked`` tenants (concurrency share enforcement); ``remove``
    supports cancellation of still-queued items.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 max_queue_per_tenant: int = 256,
                 max_tenants: int = 64):
        if max_queue_per_tenant <= 0:
            raise ValueError("max_queue_per_tenant must be positive")
        self._weights = dict(weights or {})
        self._default_weight = float(default_weight)
        self._max_queue = int(max_queue_per_tenant)
        self._max_tenants = int(max_tenants)
        self._tenants: Dict[str, _Tenant] = {}
        self._vclock = 0.0  # virtual time of the last pop
        self._lock = threading.Lock()
        self._seq = itertools.count()  # FIFO tiebreak within a tenant

    # ------------------------------------------------------------ naming
    def bucket(self, tenant: Optional[str]) -> str:
        """The bounded tenant-name bucket: configured tenants keep their
        identity, unconfigured ones do until ``max_tenants`` distinct
        names exist, then share the overflow bucket."""
        t = tenant or DEFAULT_TENANT
        if t in self._weights or t in self._tenants:
            return t
        if len(self._tenants) >= self._max_tenants:
            return OVERFLOW_TENANT
        return t

    def weight_of(self, tenant: str) -> float:
        return self._weights.get(tenant, self._default_weight)

    # ------------------------------------------------------------- queue
    def submit(self, item, tenant: Optional[str] = None,
               cost: float = 1.0):
        """Enqueue ``item`` for ``tenant``; raises the taxonomy
        ``QueueFull`` (backpressure) when the tenant's backlog is at
        capacity. Returns the bucketed tenant name the item landed on."""
        with self._lock:
            name = self.bucket(tenant)
            t = self._tenants.get(name)
            if t is None:
                # an idle/new tenant starts at the global clock: sleeping
                # must not bank credit against active tenants
                t = _Tenant(name, self.weight_of(name), self._vclock)
                self._tenants[name] = t
            if len(t.items) >= self._max_queue:
                raise QueueFull(
                    f"tenant {name!r} backlog full "
                    f"({len(t.items)}/{self._max_queue}); retry later")
            t.items.append((max(1.0, float(cost)), next(self._seq), item))
            return name

    def pop(self, blocked: Iterable[str] = ()) -> Optional[Tuple[object, str]]:
        """Dequeue the next item by weighted fairness, skipping tenants
        in ``blocked`` (at their concurrency share). Returns ``(item,
        tenant)`` or None when nothing admissible is queued."""
        blocked = set(blocked)
        with self._lock:
            best: Optional[_Tenant] = None
            for t in self._tenants.values():
                if not t.items or t.name in blocked:
                    continue
                if best is None or (t.vtime, t.name) < (best.vtime,
                                                        best.name):
                    best = t
            if best is None:
                return None
            cost, _, item = best.items.popleft()
            # idle-clamp on the way OUT too: a tenant that drained and
            # re-queued keeps pace with the global clock
            best.vtime = max(best.vtime, self._vclock) + cost / best.weight
            self._vclock = max(self._vclock, best.vtime - cost / best.weight)
            return item, best.name

    def remove(self, item) -> bool:
        """Drop a still-queued item (cancellation); False if absent."""
        with self._lock:
            for t in self._tenants.values():
                for entry in t.items:
                    if entry[2] is item:
                        t.items.remove(entry)
                        return True
        return False

    def __len__(self) -> int:
        with self._lock:
            return sum(len(t.items) for t in self._tenants.values())

    def depth(self, tenant: str) -> int:
        with self._lock:
            t = self._tenants.get(tenant)
            return len(t.items) if t else 0

    def queued_tenants(self) -> List[str]:
        """Tenants with a non-empty backlog (fairness bookkeeping for
        the frontend's concurrency-share check)."""
        with self._lock:
            return [t.name for t in self._tenants.values() if t.items]
