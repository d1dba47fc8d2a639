"""The port's observability package (``paddle_tpu_torch.observability``)
against paddle_tpu's: the same operations on a fresh registry of each give
the same Prometheus text (exact string equality), the same snapshot and
summaries; the scrape endpoint and the JSONL sink serve it; the tracer
records the same record shape and dumps the same flight record."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability.tracing import Tracer as JaxTracer

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.observability.tracing import Tracer


def _exercise(mod, seed):
    """The same metric operations through either package's API."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests", labelnames=("tenant",))
    g = reg.gauge("pages_in_use", "pages")
    h = reg.histogram("ttft_seconds", "ttft", labelnames=("tenant",))
    s = reg.histogram("batch", "batch sizes", buckets=mod.SIZE_BUCKETS)
    for _ in range(40):
        t = ["a", "b", 'c"q'][int(rng.integers(0, 3))]
        c.labels(tenant=t).inc(float(rng.integers(1, 4)))
        g.set(float(rng.integers(0, 512)))
        h.labels(tenant=t).observe(float(rng.exponential(0.05)))
        s.observe(float(rng.integers(1, 64)))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_and_prometheus_text_match_reference(seed):
    jr, tr = _exercise(jobs, seed), _exercise(tobs, seed)
    assert tobs.render_prometheus(tr) == jobs.render_prometheus(jr)
    assert tr.snapshot() == jr.snapshot()
    for name in ("requests_total", "pages_in_use"):
        assert tobs.metric_total(name, tr) == jobs.metric_total(name, jr)
    for name in ("ttft_seconds", "batch"):
        assert (tobs.histogram_summary(name, tr)
                == jobs.histogram_summary(name, jr))
    assert tobs.SIZE_BUCKETS == jobs.SIZE_BUCKETS
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS


def test_metrics_server_and_jsonl_sink(tmp_path):
    reg = _exercise(tobs, 7)
    srv = tobs.start_metrics_server(0, registry=reg, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.status == 200
            assert r.read().decode() == tobs.render_prometheus(reg)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url.replace("/metrics", "/x"), timeout=30)
        assert e.value.code == 404
    finally:
        srv.close()
    sink = tobs.JsonlSink(str(tmp_path / "m.jsonl"), registry=reg)
    sink.write({"run": 1})
    sink.write({"run": 2})
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(l)["run"] for l in lines] == [1, 2]
    assert json.loads(lines[0])["metrics"]["batch"]["type"] == "histogram"


def _trace(tracer_cls, tmp_path, tag):
    tr = tracer_cls(capacity=8)
    assert tr.start("x") is not None and not tr.enabled
    tr.configure("on", process="p", flight_dir=str(tmp_path / tag))
    with tr.start("outer", "engine", rid=1) as sp:
        tr.instant("inner", "engine", parent=sp.ctx, n=2)
    tr.complete("ttft", "ttft", 1.0, 0.5, parent="t/s")
    for i in range(10):  # past the capacity: the oldest fall out
        tr.instant(f"e{i}", "x")
    path = tr.flight_record("step-fault-RuntimeError")
    recs = tr.snapshot()
    with open(path) as f:
        dump = [json.loads(line) for line in f]
    tr.configure("off")
    return recs, dump


def test_tracer_records_match_reference(tmp_path):
    (jr, jd), (tr, td) = (_trace(JaxTracer, tmp_path, "jax"),
                          _trace(Tracer, tmp_path, "port"))
    assert len(tr) == len(jr) == 8
    assert [(r["name"], r["cat"], r["ph"], sorted(r)) for r in tr] == \
        [(r["name"], r["cat"], r["ph"], sorted(r)) for r in jr]
    assert td[0]["reason"] == jd[0]["reason"] == "step-fault-RuntimeError"
    assert td[0]["records"] == jd[0]["records"] == 8
    assert len(td) == len(jd) == 9
