"""Error taxonomy of the serving engine, after
``paddle_tpu/inference/errors.py`` (the classes this engine raises).

``RequestError`` subclasses are scoped to ONE request: the engine moves
that request to the terminal ``FAILED`` state with ``failure_reason`` set
to the class's ``reason`` slug and keeps serving the others. Admission-time
classes also subclass ``ValueError``, so callers that catch ``ValueError``
on ``add_request`` keep working. The slugs are the JAX package's, so both
engines report failures by the same names.

Pure stdlib.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "EngineError", "RequestError", "ValidationError", "AdmissionRejected",
    "PoolExhausted", "NumericsError", "StepFault", "CallbackError",
    "RetriesExhausted", "failure_reason",
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


def failure_reason(exc: BaseException) -> str:
    """The slug for any exception: the taxonomy class's ``reason``, or
    ``"unhandled"`` for foreign types."""
    return getattr(exc, "reason", None) or "unhandled"
