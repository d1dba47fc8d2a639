"""paddle_tpu_torch.observability: runtime telemetry of the port, after
``paddle_tpu/observability``.

Metrics answer continuous questions (TTFT/TPOT histograms and scheduler
gauges from the paged serving engine and its front end), exported as
Prometheus text (``start_metrics_server``) and JSONL snapshots; the tracer
answers "where did this request's time go" and dumps a flight record on a
step fault. The registry is the port's own, process-global, with the
reference's metric names.

Recording happens on the host, between dispatches. Pure stdlib.
"""
from .metrics import (
    LATENCY_BUCKETS,
    REGISTRY,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    histogram,
)
from .export import (
    JsonlSink,
    MetricsServer,
    render_prometheus,
    start_metrics_server,
    write_jsonl_snapshot,
)
from .tracing import (
    TRACER,
    Span,
    SpanContext,
    Tracer,
    complete,
    configure_tracing,
    flight_record,
    get_tracer,
    instant,
    span,
    ttft_decomposition_summary,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "counter", "gauge", "histogram",
    "render_prometheus", "MetricsServer", "start_metrics_server",
    "write_jsonl_snapshot", "JsonlSink",
    "metric_total", "histogram_summary",
    "Tracer", "TRACER", "Span", "SpanContext", "configure_tracing",
    "get_tracer", "span", "instant", "complete", "flight_record",
    "ttft_decomposition_summary",
]


def metric_total(name: str, registry: Registry = REGISTRY) -> float:
    """Sum of a counter/gauge across all label series; 0.0 if absent."""
    m = registry.get(name)
    if m is None:
        return 0.0
    return float(sum(leaf.value for _, leaf in m.series()))


def histogram_summary(name: str, registry: Registry = REGISTRY) -> dict:
    """count/sum/mean/p50/p90/p99/max of a histogram's unlabeled series
    (or count/sum/mean/max merged across label series); {} if absent."""
    m = registry.get(name)
    if not isinstance(m, Histogram):
        return {}
    leaves = [leaf for _, leaf in m.series()]
    if len(leaves) == 1:
        return leaves[0].summary()
    out = {"count": sum(l.count for l in leaves),
           "sum": sum(l.sum for l in leaves)}
    out["mean"] = out["sum"] / out["count"] if out["count"] else 0.0
    out["max"] = max((l._max for l in leaves), default=0.0)
    return out
