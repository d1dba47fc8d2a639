"""The port's serving front end (``paddle_tpu_torch.serving``) against
paddle_tpu's, after ``tests/test_api_server.py``, on tiny LLaMA with the
same weights (f32, ``page_size=8``, ``chunk_size=4``):

* ``FairQueue`` gives the reference's service order on the same
  submissions;
* ``ServingFrontend`` ticket streams equal a direct engine run and the JAX
  front end's streams for the same submissions (exact token equality); a
  cancel mid-stream frees slots and pages; the tenant starvation bound
  holds; submitting while draining is backpressure;
* ``ApiServer`` over real sockets: streamed == unary == direct, 400 for
  validation, 429 with ``Retry-After`` for backpressure, a disconnect
  cancels and frees; ``/readyz`` and ``/debug/trace`` answer with the JAX
  server's JSON keys (both servers asked directly).

Every blocking wait has its own timeout, the subprocess SIGTERM test of
``examples/serve_llama_paged_torch.py`` included (about 10 s on the CPU).
"""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.observability.tracing import TRACER as JAX_TRACER
from paddle_tpu.serving import FairQueue as JaxFairQueue
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving import parse_tenant_weights as jax_parse_weights
from paddle_tpu.serving.server import ApiServer as JaxApiServer

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.errors import QueueFull
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import REGISTRY, render_prometheus
from paddle_tpu_torch.observability.tracing import TRACER
from paddle_tpu_torch.serving import (FairQueue, ServingFrontend,
                                      parse_tenant_weights)
from paddle_tpu_torch.serving.loadgen import run_closed_loop, run_open_loop
from paddle_tpu_torch.serving.server import ApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 128
PROMPT = list(range(1, 21))
GEOM = dict(page_size=8, chunk_size=4)
WAIT = 120  # seconds any single blocking wait may take


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = llama_from_numpy(tiny_llama_config(),
                          {k: np.asarray(v)
                           for k, v in param_arrays(jm).items()},
                          device="cpu")
    return jm, tm


def make_engine(models, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_pages", 64)
    return Engine(models[1], device="cpu", **GEOM, **kw)


def make_jax_engine(models, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_pages", 64)
    return JaxEngine(models[0], dtype=jnp.float32, **GEOM, **kw)


@pytest.fixture(scope="module")
def reference(models):
    """Direct-engine greedy tokens for PROMPT (the identity target)."""
    eng = make_engine(models)
    req = eng.add_request(np.asarray(PROMPT, np.int32), 10)
    eng.run()
    assert req.done and not req.failed
    return list(req.tokens)


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _recycled(eng):
    return (len(eng._free_slots) == eng.max_slots
            and len(eng._free_pages) == eng.num_pages - 1
            and not eng._active)


class _Server:
    """An ApiServer (the port's or the JAX package's) on a thread-owned
    event loop."""

    def __init__(self, engine, server_cls=ApiServer, frontend_cls=None,
                 tenant_weights=None, **fe_kw):
        self.engine = engine
        frontend_cls = frontend_cls or ServingFrontend
        self.frontend = frontend_cls(engine, tenant_weights=tenant_weights,
                                     **fe_kw)
        self.srv = server_cls(self.frontend, port=0, grace_s=15.0)
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert _wait_until(lambda: self.srv.port, 30), "server never bound"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.srv.start())
        self.loop.run_forever()

    @property
    def base(self):
        return f"http://127.0.0.1:{self.srv.port}"

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=WAIT) as r:
            return r.status, json.loads(r.read())

    def post(self, path, payload, tenant=None, stream=False, timeout=WAIT):
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Tenant"] = tenant
        req = urllib.request.Request(self.base + path,
                                     data=json.dumps(payload).encode(),
                                     headers=headers)
        if not stream:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        toks = []
        with urllib.request.urlopen(req, timeout=timeout) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                if line[6:] == "[DONE]":
                    break
                toks.extend(
                    json.loads(line[6:])["choices"][0]["token_ids"])
        return toks

    def close(self):
        fut = asyncio.run_coroutine_threadsafe(self.srv.shutdown(),
                                               self.loop)
        fut.result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()
        self.loop.close()


# --------------------------------------------------------------- fairness
def _fair_script(seed):
    """Submissions [(item, tenant, cost)] and pops (the blocked sets)."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "d"]
    subs = [(i, tenants[int(rng.integers(0, 4))],
             float(rng.integers(1, 200))) for i in range(40)]
    blocks = [tuple(t for t in tenants if rng.random() < 0.25)
              for _ in range(40)]
    return subs, blocks


@pytest.mark.parametrize("seed", range(4))
def test_fair_queue_service_order_matches_reference(seed):
    """The same submissions, interleaved with pops under the same blocked
    sets and one removal, come out in the same order with the same tenant
    buckets."""
    subs, blocks = _fair_script(seed)
    weights = {"a": 4.0, "b": 1.0, "c": 2.5}
    orders = []
    for cls in (JaxFairQueue, FairQueue):
        q = cls(weights=weights, max_queue_per_tenant=64, max_tenants=3)
        got = []
        for i, (item, tenant, cost) in enumerate(subs):
            got.append(("sub", q.submit(item, tenant=tenant, cost=cost)))
            if i % 3 == 2:
                got.append(("pop", q.pop(blocked=blocks[i])))
        got.append(("rm", q.remove(subs[-1][0])))
        while True:
            popped = q.pop()
            if popped is None:
                break
            got.append(("pop", popped))
        orders.append(got)
    assert orders[0] == orders[1]


class TestFairQueue:
    def test_weighted_service_order(self):
        q = FairQueue(weights={"a": 2.0, "b": 1.0})
        for i in range(6):
            q.submit(("a", i), tenant="a", cost=10)
            q.submit(("b", i), tenant="b", cost=10)
        order = [q.pop()[1] for _ in range(9)]
        assert order.count("a") >= 2 * order.count("b") - 1

    def test_big_request_charges_its_tenant(self):
        q = FairQueue()
        q.submit("huge", tenant="a", cost=1000)
        for i in range(4):
            q.submit(("small", i), tenant="b", cost=10)
        assert q.pop()[0] in ("huge", ("small", 0))
        assert [q.pop()[1] for _ in range(3)].count("b") >= 2

    def test_backpressure_and_removal(self):
        q = FairQueue(max_queue_per_tenant=2)
        q.submit(1, tenant="t")
        q.submit(2, tenant="t")
        with pytest.raises(QueueFull):
            q.submit(3, tenant="t")
        assert q.remove(1) and not q.remove(1)
        q.submit(3, tenant="t")

    def test_tenant_cardinality_bounded(self):
        q = FairQueue(max_tenants=4)
        for i in range(16):
            q.submit(i, tenant=f"t{i}")
        assert len(q.queued_tenants()) <= 5  # 4 named + "other"

    @pytest.mark.parametrize("spec", [None, "", "a=4, b=1.5",
                                      "interactive=4,batch=1,"])
    def test_parse_tenant_weights_matches_reference(self, spec):
        assert parse_tenant_weights(spec) == jax_parse_weights(spec)

    @pytest.mark.parametrize("spec", ["a=0", "justaname", "=3"])
    def test_parse_tenant_weights_rejects(self, spec):
        with pytest.raises(ValueError):
            parse_tenant_weights(spec)
        with pytest.raises(ValueError):
            jax_parse_weights(spec)


# --------------------------------------------------------------- frontend
SUBMISSIONS = [  # (prompt seed, length, budget, temperature, tenant)
    (1, 9, 10, 0.0, "interactive"), (2, 14, 7, 0.8, "batch"),
    (3, 5, 12, 0.0, "batch"), (4, 11, 6, 0.0, "interactive"),
]


def _submissions():
    out = []
    for seed, n, m, t, tenant in SUBMISSIONS:
        p = np.random.default_rng(seed).integers(0, VOCAB, (n,))
        out.append((p, m, t, 100 + seed, tenant))
    return out


def _through_frontend(fe):
    tickets = [fe.submit(p, m, temperature=t, seed=s, tenant=tenant)
               for p, m, t, s, tenant in _submissions()]
    toks = [t.result(timeout=WAIT) for t in tickets]
    assert all(t.done and not t.failure_reason for t in tickets)
    return toks, tickets


class TestFrontend:
    def test_ticket_stream_matches_direct_engine(self, models, reference):
        fe = ServingFrontend(make_engine(models)).start()
        try:
            chunks = []
            t = fe.submit(PROMPT, 10, on_chunk=lambda c: chunks.append(c))
            assert t.result(timeout=WAIT) == reference
            flat = [tok for c in chunks if c for tok in c]
            assert flat == reference and chunks[-1] is None
            assert t.ttft_s is not None and t.ttft_s >= 0
        finally:
            fe.shutdown()

    @pytest.mark.parametrize("multi", [1, 4])
    def test_streams_match_reference_frontend(self, models, multi):
        """Four submissions over two tenants (one sampled) through the
        JAX front end and the port's give the same streams, equal to one
        direct engine run of the same requests."""
        direct = make_engine(models)
        reqs = [direct.add_request(p, m, temperature=t, seed=s)
                for p, m, t, s, _ in _submissions()]
        direct.run()
        want = [r.tokens for r in reqs]
        got = []
        for fe in (JaxFrontend(make_jax_engine(models, multi_step=multi)),
                   ServingFrontend(make_engine(models, multi_step=multi))):
            fe.start()
            try:
                got.append(_through_frontend(fe)[0])
            finally:
                fe.shutdown()
        assert got[0] == got[1] == want

    def test_cancel_mid_stream_frees_slots_and_pages(self, models):
        eng = make_engine(models)
        fe = ServingFrontend(eng).start()
        try:
            got = threading.Event()
            t = fe.submit(PROMPT, 80, on_chunk=lambda c: c and got.set())
            assert got.wait(timeout=WAIT), "stream never started"
            fe.cancel(t)
            t.result(timeout=WAIT)
            assert t.failure_reason == "cancelled"
            assert _wait_until(lambda: _recycled(eng))
            assert np.all(eng.tables == 0)
        finally:
            fe.shutdown()

    def test_tenant_starvation_bound(self, models):
        """Weights 4:1 over 2 slots: the batch tenant caps at one slot, so
        an interactive request admits without waiting out the flood."""
        eng = make_engine(models, max_chain=1)
        fe = ServingFrontend(
            eng, tenant_weights={"interactive": 4.0, "batch": 1.0}).start()
        try:
            r = np.random.default_rng(7)
            flood = [fe.submit(r.integers(0, VOCAB, (24,)), 60,
                               tenant="batch") for _ in range(6)]
            assert _wait_until(lambda: eng._active, 30)
            inter = fe.submit(r.integers(0, VOCAB, (8,)), 4,
                              tenant="interactive")
            inter.result(timeout=WAIT)
            assert not inter.failure_reason
            done_batch = sum(1 for b in flood if b.done)
            assert done_batch <= 2, (
                f"interactive waited out {done_batch} batch requests")
            for b in flood:
                b.result(timeout=WAIT)
            assert all(not b.failure_reason for b in flood)
        finally:
            fe.shutdown()

    def test_submit_while_draining_is_backpressure(self, models):
        fe = ServingFrontend(make_engine(models)).start()
        t = fe.submit(PROMPT, 4)
        assert fe.drain(grace_s=60.0)
        assert t.done and not t.failure_reason
        with pytest.raises(QueueFull):
            fe.submit(PROMPT, 4)

    def test_validation_error_fails_ticket_not_loop(self, models):
        fe = ServingFrontend(make_engine(models)).start()
        try:
            bad = fe.submit([0] * 500, 10)  # prompt beyond max_position
            bad.result(timeout=WAIT)
            assert bad.failure_reason == "validation"
            ok = fe.submit(PROMPT, 4)
            assert ok.result(timeout=WAIT) and not ok.failure_reason
        finally:
            fe.shutdown()

    def test_slow_client_is_cancelled(self, models, monkeypatch):
        """A pull consumer that never reads past the stall budget is
        cancelled and its slot and pages freed. The engine's step is
        slowed to 20 ms, so the 25 steps of the budget outlast the 50 ms
        stall budget on any host."""
        eng = make_engine(models, max_chain=1)
        step = eng.step

        def slow_step(n=None):
            time.sleep(0.02)
            return step(n)

        monkeypatch.setattr(eng, "step", slow_step)
        fe = ServingFrontend(eng, stream_stall_s=0.05).start()
        c0 = REGISTRY.get("paddle_tpu_slow_client_cancels_total").value
        try:
            t = fe.submit(PROMPT, 100)
            t.result(timeout=WAIT)
            assert t.failure_reason == "cancelled" and t.stall_cancelled
            assert len(t.tokens) < 100
            assert _wait_until(lambda: _recycled(eng))
            assert REGISTRY.get(
                "paddle_tpu_slow_client_cancels_total").value == c0 + 1
        finally:
            fe.shutdown()

    def test_call_runs_on_the_engine_thread(self, models):
        fe = ServingFrontend(make_engine(models)).start()
        try:
            assert fe.call(lambda: threading.current_thread().name,
                           timeout=WAIT) == "paddle-engine-core"
            with pytest.raises(KeyError):
                fe.call(lambda: {}["x"], timeout=WAIT)
        finally:
            fe.shutdown()
        with pytest.raises(RuntimeError):
            fe.call(lambda: 1, timeout=1.0)

    def test_escaped_engine_fault_ends_streams(self, models, monkeypatch):
        """A fault that escapes ``Engine.step`` (one the card cannot
        survive) ends the engine thread: the live and queued tickets end
        with reason ``engine``, the fault is kept, new submissions are
        backpressure."""
        eng = make_engine(models, max_slots=1)
        fe = ServingFrontend(eng)

        def dead_step(n=None):
            raise RuntimeError("device context lost")

        monkeypatch.setattr(eng, "step", dead_step)
        tickets = [fe.submit(PROMPT, 8) for _ in range(3)]
        fe.start()
        for t in tickets:
            t.result(timeout=WAIT)
        assert [t.failure_reason for t in tickets] == ["engine"] * 3
        assert isinstance(fe.fault, RuntimeError)
        assert _wait_until(lambda: not fe.alive)
        with pytest.raises(QueueFull):
            fe.submit(PROMPT, 4)
        fe.shutdown()

    def test_loadgen_drives_the_frontend(self, models):
        fe = ServingFrontend(make_engine(models, max_slots=3)).start()
        try:
            closed = run_closed_loop(fe, concurrency=3, n_requests=6,
                                     vocab=VOCAB, prompt_range=(4, 12),
                                     budget=5, timeout_s=WAIT)
            opened = run_open_loop(fe, qps=200.0, n_requests=4, vocab=VOCAB,
                                   prompt_range=(4, 12), budget=3,
                                   timeout_s=WAIT)
        finally:
            fe.shutdown()
        assert closed["completed"] == 6 and closed["tokens"] == 30
        assert closed["tokens_per_sec"] > 0 and closed["ttft_p99_ms"] > 0
        assert opened["completed"] == 4 and opened["tokens"] == 12


# ----------------------------------------------------------------- server
class TestApiServer:
    @pytest.fixture(scope="class")
    def server(self, models):
        s = _Server(make_engine(models, multi_step=4),
                    tenant_weights={"interactive": 4.0, "batch": 1.0})
        yield s
        s.close()

    def test_streamed_equals_unary_equals_direct(self, server, reference):
        unary = server.post("/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 10})
        assert unary["choices"][0]["token_ids"] == reference
        assert unary["choices"][0]["finish_reason"] == "stop"
        assert unary["usage"]["completion_tokens"] == len(reference)
        streamed = server.post("/v1/completions",
                               {"prompt": PROMPT, "max_tokens": 10,
                                "stream": True}, stream=True)
        assert streamed == reference
        chat = server.post("/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "hi"}],
                            "max_tokens": 4, "stream": True}, stream=True)
        assert len(chat) == 4

    def test_chat_and_models_and_health(self, server):
        chat = server.post("/v1/chat/completions",
                           {"messages": [
                               {"role": "user", "content": "hello"}],
                            "max_tokens": 4})
        assert len(chat["choices"][0]["token_ids"]) == 4
        assert chat["choices"][0]["message"]["role"] == "assistant"
        assert server.get("/v1/models")[1]["data"][0]["id"]
        status, body = server.get("/healthz")
        assert status == 200 and body["status"] == "ok"
        status, body = server.get("/readyz")
        assert status == 200 and body["ready"] is True

    @pytest.mark.parametrize("path,payload", [
        ("/v1/completions", {"prompt": 7}),
        ("/v1/completions", {"prompt": []}),
        ("/v1/completions", {"prompt": [1, 2.5]}),
        ("/v1/completions", {"prompt": [1], "resume_tokens": "x"}),
        ("/v1/chat/completions", {"messages": []})])
    def test_validation_maps_to_400(self, server, path, payload):
        with pytest.raises(urllib.error.HTTPError) as e:
            server.post(path, payload)
        assert e.value.code == 400
        assert json.loads(e.value.read())["error"]["type"] == "validation"

    @pytest.mark.parametrize("payload", [
        {"prompt": [1, 2], "max_tokens": 0}, {"prompt": [1, VOCAB + 5]}])
    def test_engine_validation_ends_the_stream(self, server, payload):
        """What only the engine can judge (the budget, the vocab) is
        judged on the engine thread after the submission was taken, as in
        the reference: the response is a 200 whose finish_reason is the
        taxonomy slug."""
        got = server.post("/v1/completions", payload)
        assert got["choices"][0]["finish_reason"] == "validation"
        assert got["choices"][0]["token_ids"] == []

    def test_string_prompt_and_token_prompt_agree(self, server):
        a = server.post("/v1/completions",
                        {"prompt": "hello world", "max_tokens": 4})
        ids = [b % VOCAB for b in b"hello world"]
        b2 = server.post("/v1/completions", {"prompt": ids, "max_tokens": 4})
        assert (a["choices"][0]["token_ids"]
                == b2["choices"][0]["token_ids"])

    def test_unknown_routes_answer_404(self, server):
        for method, path in (("GET", "/nope"), ("POST", "/v1/embeddings")):
            req = urllib.request.Request(
                server.base + path, method=method,
                data=b"{}" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=WAIT)
            assert e.value.code == 404
            assert json.loads(e.value.read())["error"]["type"] == "not_found"

    def test_disconnect_mid_stream_cancels_and_frees(self, server):
        eng = server.engine
        payload = json.dumps({"prompt": PROMPT, "max_tokens": 90,
                              "stream": True}).encode()
        raw = socket.create_connection(("127.0.0.1", server.srv.port),
                                       timeout=WAIT)
        raw.sendall(
            b"POST /v1/completions HTTP/1.1\r\n"
            b"Host: x\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(payload)}\r\n\r\n".encode()
            + payload)
        assert raw.recv(4096)  # headers + first chunk(s) flowing
        raw.close()
        assert _wait_until(lambda: _recycled(eng), 60), \
            "disconnected stream still decoding"

    def test_scrape_counts_ttft(self, server):
        text = render_prometheus()
        assert "paddle_serving_ttft_seconds_count" in text
        assert "paddle_tpu_engine_steps_per_roundtrip_bucket" in text


def test_backpressure_maps_to_429(models, monkeypatch):
    """Tenant backlog full → 429 with ``Retry-After``. The engine's step
    is slowed to 50 ms so the occupied-slot window is deterministic."""
    eng = make_engine(models, max_slots=1, max_chain=1)
    step = eng.step

    def slow_step(n=None):
        time.sleep(0.05)
        return step(n)

    monkeypatch.setattr(eng, "step", slow_step)
    s = _Server(eng)
    try:
        s.frontend.queue._max_queue = 1
        occ = s.frontend.submit(PROMPT, 100)
        assert _wait_until(lambda: occ.rid is not None, 30)
        queued = s.frontend.submit(PROMPT, 8)
        with pytest.raises(urllib.error.HTTPError) as e:
            s.post("/v1/completions", {"prompt": PROMPT, "max_tokens": 8},
                   timeout=30)
        assert e.value.code == 429
        assert int(e.value.headers["Retry-After"]) >= 1
        assert json.loads(e.value.read())["error"]["type"] == "queue_full"
        occ.result(timeout=WAIT)
        queued.result(timeout=WAIT)
    finally:
        s.close()


def _key_tree(obj):
    """The nested key structure of a JSON value (lists by their first
    element)."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_key_tree(obj[0])] if obj else []
    return type(obj).__name__ if obj is not None else None


@pytest.fixture
def both_servers(models):
    pair = (_Server(make_jax_engine(models, prefix_cache=True),
                    server_cls=JaxApiServer, frontend_cls=JaxFrontend),
            _Server(make_engine(models, prefix_cache=True)))
    yield pair
    for s in pair:
        s.close()
    for tr in (JAX_TRACER, TRACER):
        tr.configure("off")
        tr.clear()


def test_readyz_and_debug_trace_match_reference(both_servers):
    """``/readyz`` and ``/debug/trace`` of the JAX server and the port's,
    asked directly: the same status and the same JSON keys (tracing off:
    both 404 ``tracing_off``; on: the same record keys)."""
    for s in both_servers:
        assert s.post("/v1/completions", {"prompt": PROMPT,
                                          "max_tokens": 4})
    ready = [s.get("/readyz") for s in both_servers]
    assert ready[0][0] == ready[1][0] == 200
    assert _key_tree(ready[0][1]) == _key_tree(ready[1][1])
    for s in both_servers:
        with pytest.raises(urllib.error.HTTPError) as e:
            s.get("/debug/trace")
        assert e.value.code == 404
        assert json.loads(e.value.read())["error"]["type"] == "tracing_off"
    for tr in (JAX_TRACER, TRACER):
        tr.configure("on")
        tr.clear()
    traces = []
    for s in both_servers:
        s.post("/v1/completions", {"prompt": PROMPT, "max_tokens": 4})
        status, body = s.get("/debug/trace")
        assert status == 200 and body["records"]
        traces.append(body)
    assert set(traces[0]) == set(traces[1])
    assert ({k for r in traces[0]["records"] for k in r}
            == {k for r in traces[1]["records"] for k in r})
    names = [{(r["name"], r["cat"]) for r in t["records"]} for t in traces]
    assert names[0] == names[1]


# ------------------------------------------------------------- subprocess
def test_example_serves_and_drains_on_sigterm():
    """``serve_llama_paged_torch.py --api-port`` serves streams from its own
    process, and SIGTERM mid-stream drains (the stream finishes, the
    process exits 0)."""
    proc = subprocess.Popen(
        [sys.executable, "-u",
         os.path.join(REPO, "examples", "serve_llama_paged_torch.py"),
         "--tiny", "--device", "cpu", "--api-port", "0",
         "--multi-step", "2", "--tenant-weights", "interactive=4,batch=1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("api: http"):
                port = int(line.split("/v1/")[0].rsplit(":", 1)[1])
                break
        assert port is not None, proc.stderr.read()
        base = f"http://127.0.0.1:{port}"

        def stream(n):
            req = urllib.request.Request(
                base + "/v1/completions",
                data=json.dumps({"prompt": PROMPT, "max_tokens": n,
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            toks = []
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    if line[6:] == "[DONE]":
                        break
                    toks.extend(json.loads(line[6:])
                                ["choices"][0]["token_ids"])
            return toks

        first = stream(8)
        assert len(first) == 8
        assert stream(8) == first
        got = {}
        t = threading.Thread(target=lambda: got.update(toks=stream(60)))
        t.start()
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=WAIT)
        assert not t.is_alive() and got.get("toks")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
