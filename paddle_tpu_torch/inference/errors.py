"""Error taxonomy of the serving engine, after
``paddle_tpu/inference/errors.py`` (the classes this engine raises).

``RequestError`` subclasses are scoped to ONE request: the engine moves
that request to the terminal ``FAILED`` state with ``failure_reason`` set
to the class's ``reason`` slug and keeps serving the others. Admission-time
classes also subclass ``ValueError``, so callers that catch ``ValueError``
on ``add_request`` keep working. ``EngineFault`` is a whole-step fault: a
dispatch raised, and ``Engine.step`` recovers by requeueing every active
request (``_recover_step_fault``). The slugs are the JAX package's, so
both engines report failures by the same names (they are the ``reason``
label of ``paddle_tpu_request_failures_total``).

Pure stdlib.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "EngineError", "RequestError", "ValidationError", "AdmissionRejected",
    "QueueFull", "DeadlineExceeded", "CancelledError", "PoolExhausted",
    "NumericsError", "StepFault", "CallbackError", "RetriesExhausted",
    "IntegrityError", "EngineFault", "failure_reason",
]


class EngineError(Exception):
    """Base of every taxonomy error; ``reason`` is the stable slug stored
    on ``Request.failure_reason``."""

    reason = "engine"

    def __init__(self, message: str = "", rid: Optional[int] = None):
        super().__init__(message)
        self.rid = rid


class RequestError(EngineError):
    """A fault scoped to one request."""

    reason = "request"


class ValidationError(RequestError, ValueError):
    """Malformed at submission: empty prompt, ids outside the vocab,
    non-integer ids, a non-positive budget, a negative temperature, or a
    prompt that leaves no room to generate."""

    reason = "validation"


class AdmissionRejected(RequestError, ValueError):
    """The request can never be served by this engine's geometry (it needs
    more KV pages than the pool or the per-sequence table holds)."""

    reason = "admission_rejected"


class QueueFull(AdmissionRejected):
    """Backpressure: the bounded wait queue (``Engine(max_queue=...)``) or
    a tenant's backlog in the front end is at capacity; shed or retry
    later (the HTTP server answers 429)."""

    reason = "queue_full"


class DeadlineExceeded(RequestError):
    """The request's deadline elapsed, queued or mid-decode; the engine
    expires it at the top of the next step."""

    reason = "deadline"


class CancelledError(RequestError):
    """``Engine.cancel(rid)`` hit the request before it finished."""

    reason = "cancelled"


class PoolExhausted(RequestError):
    """KV page pressure the request cannot survive: alone in the batch and
    still short of pages, or outgrowing the per-sequence table."""

    reason = "pool_exhausted"


class NumericsError(RequestError):
    """The NaN/inf logit guard flagged this request's row."""

    reason = "nan_logits"


class StepFault(RequestError):
    """An unexpected exception while processing ONE request's harvest;
    the original is the ``__cause__``."""

    reason = "step_fault"


class CallbackError(StepFault):
    """The request's ``on_token`` streaming callback raised."""

    reason = "callback"


class RetriesExhausted(RequestError):
    """The request was preempted or requeued more than ``max_retries``
    times."""

    reason = "retries_exhausted"


class IntegrityError(RequestError):
    """Silent data corruption caught by the integrity layer
    (``integrity.py``): a KV page's checksum changed between registration
    and splice, a weight block's audit digest drifted from the load-time
    baseline, or a shadow-recomputed token disagrees with the one the
    paged path delivered. Its cause is never the request: the containment
    ladder decides the blast radius (a cache miss for KV, a requeue or a
    failed request for an active page or a shadow divergence, quarantine
    for weights). A handler that can absorb it must re-raise it or route
    it into the taxonomy."""

    reason = "integrity"


class EngineFault(EngineError):
    """A whole-step fault: a dispatch (or the step's host spine) raised.
    Recovery is engine-level (requeue every active request, reset the
    allocator), not per request."""

    reason = "engine"


def failure_reason(exc: BaseException) -> str:
    """The slug for any exception: the taxonomy class's ``reason``, or
    ``"unhandled"`` for foreign types."""
    return getattr(exc, "reason", None) or "unhandled"
