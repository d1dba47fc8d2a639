"""paddle_tpu_torch.serving: the streaming front end of the port and its
multi-replica layer, after ``paddle_tpu/serving``.

* :mod:`fairness`: ``FairQueue``, the weighted-fair multi-tenant request
  queue (stride scheduling with per-tenant admission bounds) in front of
  the engine.
* :mod:`frontend`: ``ServingFrontend``, the engine-core loop on its own
  thread (every ``Engine`` call happens there), multi-step when the queue
  is idle, stream tickets, the graceful drain, ``poison()``.
* :mod:`server`: ``ApiServer``, an OpenAI-compatible streaming HTTP server
  (stdlib asyncio; SSE ``/v1/completions`` and ``/v1/chat/completions``,
  ``POST /v1/kv`` for the KV handoff).
* :mod:`loadgen`: open- and closed-loop load that drives a front end or a
  router, and the serving benches (SLO, tracing cost, failover, cluster).
* :mod:`replica` / :mod:`router`: supervised engine replicas (in-process,
  or worker processes behind the ApiServer protocol) with split liveness
  and readiness, health-gated routing, and KV-free mid-stream migration: a
  dead replica's streams re-admit elsewhere as prompt‖emitted and the
  client sees one uninterrupted, bit-identical token sequence. An
  in-process replica over a sharded engine (tp/ep > 1) lives on rank 0;
  every other rank of its group runs ``follow_replica(factory)``.
* :mod:`cluster`: ``Router(pools={"prefill": k, "decode": m})`` splits the
  replicas into role pools, ships a prompt's KV from its prefill replica
  to its decode replica (digest-verified; every failure degrades to
  recompute), places by prefix-chain overlap before load, and autoscales
  the pools.
"""
from .cluster import ClusterCoordinator, parse_pools
from .fairness import DEFAULT_TENANT, FairQueue, parse_tenant_weights
from .frontend import ServingFrontend, StreamTicket
from .replica import (InProcReplica, Replica, StreamSpec, SubprocessReplica,
                      follow_replica)
from .router import Router, RouterTicket

__all__ = [
    "DEFAULT_TENANT", "FairQueue", "parse_tenant_weights",
    "ServingFrontend", "StreamTicket",
    "Replica", "InProcReplica", "SubprocessReplica", "StreamSpec",
    "follow_replica",
    "Router", "RouterTicket",
    "ClusterCoordinator", "parse_pools",
]
