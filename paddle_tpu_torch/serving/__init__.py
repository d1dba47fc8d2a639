"""paddle_tpu_torch.serving: the streaming front end of the port, after
``paddle_tpu/serving``.

* :mod:`fairness`: ``FairQueue``, the weighted-fair multi-tenant request
  queue (stride scheduling with per-tenant admission bounds) in front of
  the engine.
* :mod:`frontend`: ``ServingFrontend``, the engine-core loop on its own
  thread (every ``Engine`` call happens there), multi-step when the queue
  is idle, stream tickets, the graceful drain.
* :mod:`server`: ``ApiServer``, an OpenAI-compatible streaming HTTP server
  (stdlib asyncio; SSE ``/v1/completions`` and ``/v1/chat/completions``).
* :mod:`loadgen`: open- and closed-loop load that drives a front end.
* :mod:`replica`: the KV handoff payload's JSON codec (``POST /v1/kv``).

The reference's multi-replica layer (``Router``, ``Replica``,
``ClusterCoordinator``) is not ported yet.
"""
from .fairness import DEFAULT_TENANT, FairQueue, parse_tenant_weights
from .frontend import ServingFrontend, StreamTicket

__all__ = [
    "DEFAULT_TENANT", "FairQueue", "parse_tenant_weights",
    "ServingFrontend", "StreamTicket",
]
