"""Metric export surfaces of the port, after
``paddle_tpu/observability/export.py``: Prometheus text exposition (and
an HTTP endpoint for it) and JSONL snapshots.

* **Prometheus**: text exposition format 0.0.4; histograms emit the
  cumulative ``_bucket{le=}`` / ``_sum`` / ``_count`` triple, so stock
  ``histogram_quantile`` works unmodified.
* **JSONL**: one self-contained snapshot line per call, append-only.

The HTTP server is stdlib ``ThreadingHTTPServer`` on a daemon thread;
scrapes read the registry without locks (a scrape racing an update sees
a value at most one sample stale), so serving ``/metrics`` never stalls
the scheduler. The reference's TensorBoard bridge (``TBEventsBridge``)
waits for a port of ``utils/tbevents``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from .metrics import REGISTRY, Histogram, Registry

__all__ = [
    "render_prometheus", "MetricsServer", "start_metrics_server",
    "write_jsonl_snapshot", "JsonlSink",
]


# ------------------------------------------------------ prometheus text


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(pairs) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """Text exposition format 0.0.4 for every metric in the registry."""
    registry = registry or REGISTRY
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, leaf in m.series():
            pairs = m.label_pairs(key)
            if isinstance(m, Histogram):
                cum = leaf.cumulative()
                for bound, c in zip(leaf.bounds, cum[:-1]):
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(pairs + [('le', _fmt_value(bound))])}"
                        f" {c}")
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(pairs + [('le', '+Inf')])} {cum[-1]}")
                lines.append(
                    f"{m.name}_sum{_fmt_labels(pairs)} "
                    f"{_fmt_value(leaf.sum)}")
                lines.append(
                    f"{m.name}_count{_fmt_labels(pairs)} {leaf.count}")
            else:
                lines.append(
                    f"{m.name}{_fmt_labels(pairs)} {_fmt_value(leaf.value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------- HTTP server


class MetricsServer:
    """Prometheus scrape endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``.port``. Serves ``GET /metrics``; anything else is 404. ``close()``
    shuts the listener down (idempotent).
    """

    def __init__(self, port: int = 0, registry: Optional[Registry] = None,
                 host: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = registry or REGISTRY

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                body = render_prometheus(registry).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes every few seconds would spam stderr

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-metrics",
            daemon=True)
        self._thread.start()

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def start_metrics_server(port: int = 0,
                         registry: Optional[Registry] = None,
                         host: str = "") -> MetricsServer:
    """Start serving ``/metrics`` in the background; returns the server
    (``.port`` has the bound port, ``.close()`` stops it)."""
    return MetricsServer(port=port, registry=registry, host=host)


# ----------------------------------------------------------- JSONL sink


def write_jsonl_snapshot(path: str, registry: Optional[Registry] = None,
                         extra: Optional[Dict] = None) -> Dict:
    """Append one self-contained snapshot line to ``path``. Returns the
    record written."""
    registry = registry or REGISTRY
    record = {"ts": time.time(), "metrics": registry.snapshot()}
    if extra:
        record.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


class JsonlSink:
    """Bound (path, registry) snapshot writer for periodic dumps."""

    def __init__(self, path: str, registry: Optional[Registry] = None):
        self.path = path
        self.registry = registry or REGISTRY

    def write(self, extra: Optional[Dict] = None) -> Dict:
        return write_jsonl_snapshot(self.path, self.registry, extra)
