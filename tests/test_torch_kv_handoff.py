"""The port's KV handoff (``CacheCoordinator.export_handoff``,
``Engine.adopt_kv_pages``, ``ServingFrontend.export_kv`` / ``import_kv``,
``POST /v1/kv`` and the payload codec of ``serving/replica.py``) against
paddle_tpu's, on tiny LLaMA with the same weights (f32, pages of 8).

* A payload the JAX engine exports, adopted by the port's engine, gives
  the JAX engine's streams (and the port's own recompute): the adopted
  pages splice.
* Adoption stops at the first page whose digest fails, on both engines
  alike; a payload of another page size is refused.
* ``/v1/kv`` over real sockets answers as the JAX server does: 200 for
  export and import (a JAX-exported payload imports into the port), 400
  for bad JSON and an unknown op, 503 (``kv_handoff``) for a payload
  that cannot be decoded.
* The codec round-trips bf16 rows as raw words without ``ml_dtypes`` and
  reads the JAX codec's JSON (f32 and bf16) to the same bits.
"""
import asyncio
import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving.replica import decode_kv_payload as jax_decode
from paddle_tpu.serving.replica import encode_kv_payload as jax_encode
from paddle_tpu.serving.server import ApiServer as JaxApiServer

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.serving import ServingFrontend
from paddle_tpu_torch.serving.replica import (decode_kv_payload,
                                              encode_kv_payload)
from paddle_tpu_torch.serving.server import ApiServer
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 128
WAIT = 120
PROMPT = np.random.default_rng(11).integers(0, VOCAB, (45,)).astype(np.int32)


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


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("chunk_size", 4)
    kw.setdefault("prefix_cache", True)
    return kw


def port(models, **kw):
    return Engine(models[1], device="cpu", **_kw(kw))


def jax(models, **kw):
    return JaxEngine(models[0], dtype=jnp.float32, **_kw(kw))


def _serve(eng, prompt=PROMPT, n=10, temp=0.0, seed=None):
    req = eng.add_request(prompt, n, temperature=temp, seed=seed)
    eng.run()
    assert req.done and not req.failed
    return list(req.tokens)


def _exported(eng):
    """Serve PROMPT on ``eng`` and export its cached pages."""
    _serve(eng)
    pay = eng._cache.export_handoff(PROMPT)
    assert pay is not None and len(pay["pages"]) == PROMPT.size // 8
    return pay


# ------------------------------------------------------------- adoption
@pytest.mark.parametrize("temp,seed", [(0.0, None), (0.8, 7)])
def test_jax_payload_adopted_by_port_gives_jax_streams(models, temp, seed):
    je = jax(models)
    pay = _exported(je)
    want = _serve(je, PROMPT, 12, temp, seed)
    recompute = _serve(port(models), PROMPT, 12, temp, seed)
    te = port(models, integrity="audit")
    h0 = te._pcache.hits
    assert te.adopt_kv_pages(pay) == len(pay["pages"])
    assert _serve(te, PROMPT, 12, temp, seed) == want == recompute
    assert te._pcache.hits == h0 + 1  # the adopted pages spliced
    # checksummed from the restored bytes: the splice probe passed
    assert te._integrity.last_error is None


def test_port_payload_shape_matches_reference(models):
    """Both engines ship the same tokens, pages, row shapes and dtypes
    (the bytes may differ in the last bits: two numeric paths)."""
    jp, tp = _exported(jax(models)), _exported(port(models))
    assert tp["tokens"] == jp["tokens"]
    assert tp["page_size"] == jp["page_size"]
    assert tp["nbytes"] == jp["nbytes"]
    assert len(tp["pages"]) == len(jp["pages"])
    for jr, tr in zip(jp["pages"], tp["pages"]):
        assert [tuple(r.shape) for r in tr] == \
            [tuple(np.asarray(r).shape) for r in jr]
        assert all(r.dtype == torch.float32 for r in tr)
    assert tp["dev_sums"] == [None] * len(tp["pages"])


def test_port_to_port_through_the_codec(models):
    src = port(models)
    pay = _exported(src)
    wire = json.loads(json.dumps(encode_kv_payload(pay)))
    dst = port(models)
    assert dst.adopt_kv_pages(decode_kv_payload(wire)) == len(pay["pages"])
    assert _serve(dst, PROMPT, 12) == _serve(src, PROMPT, 12)


def _damaged(pay, page):
    bad = dict(pay)
    bad["pages"] = [list(rows) for rows in pay["pages"]]
    row = np.array(bad["pages"][page][0])
    row.reshape(-1)[3] += 1.0
    bad["pages"][page][0] = row
    return bad


def test_adoption_stops_at_the_first_bad_digest(models):
    """Page 2's bytes damaged in flight: both engines adopt pages 0 and 1
    only, count one failed ``kv_handoff`` check, and the stream is
    unchanged (the rest recomputes)."""
    from paddle_tpu.observability import REGISTRY as JREG

    pay = _exported(jax(models))
    bad = _damaged(pay, 2)
    name = "paddle_tpu_integrity_failures_total"

    def fails(reg):
        m = reg.get(name)
        return 0.0 if m is None else float(sum(
            leaf.value for key, leaf in m.series() if "kv_handoff" in key))

    f0 = (fails(REGISTRY), fails(JREG))
    te, je = port(models), jax(models)
    assert te.adopt_kv_pages(bad) == je.adopt_kv_pages(bad) == 2
    assert (fails(REGISTRY) - f0[0], fails(JREG) - f0[1]) == (1.0, 1.0)
    assert _serve(te) == _serve(je)
    assert te.adopt_kv_pages(dict(pay, page_size=16)) == 0
    assert te.adopt_kv_pages({}) == 0


def test_already_cached_blocks_are_skipped(models):
    te = port(models)
    pay = _exported(te)
    pages_before = te._pcache.n_pages
    assert te.adopt_kv_pages(pay) == je_count(models, pay)
    assert te._pcache.n_pages == pages_before
    assert len(te._free_pages) + te._pcache.n_pages == te.num_pages - 1


def je_count(models, pay):
    """What the JAX engine adopts over its own export of the prompt."""
    je = jax(models)
    _serve(je)
    return je.adopt_kv_pages(pay)


# ---------------------------------------------------------- the front end
def test_frontend_export_import(models):
    src = ServingFrontend(port(models)).start()
    dst = ServingFrontend(port(models)).start()
    try:
        t = src.submit(PROMPT, 10)
        want = t.result(timeout=WAIT)
        pay = src.export_kv(PROMPT.tolist(), timeout=WAIT)
        assert src.export_kv([1, 2, 3], timeout=WAIT) is None
        assert dst.import_kv(pay, timeout=WAIT) == len(pay["pages"])
        assert dst.submit(PROMPT, 10).result(timeout=WAIT) == want
        assert dst.engine._pcache.hits == 1
    finally:
        src.shutdown()
        dst.shutdown()


# --------------------------------------------------------------- /v1/kv
class _Server:
    """An ApiServer (the port's or the JAX package's) on its own loop."""

    def __init__(self, engine, server_cls, frontend_cls):
        self.frontend = frontend_cls(engine)
        self.srv = server_cls(self.frontend, port=0, grace_s=15.0)
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        dl = time.monotonic() + 30
        while not self.srv.port and time.monotonic() < dl:
            time.sleep(0.02)
        assert self.srv.port, "server never bound"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.srv.start())
        self.loop.run_forever()

    def post(self, path, body: bytes):
        """(status, JSON body) of one POST."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.srv.port}{path}", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def kv(self, payload):
        return self.post("/v1/kv", json.dumps(payload).encode())

    def close(self):
        fut = asyncio.run_coroutine_threadsafe(self.srv.shutdown(),
                                               self.loop)
        fut.result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()
        self.loop.close()


@pytest.fixture(scope="module")
def servers(models):
    pair = {"jax": _Server(jax(models), JaxApiServer, JaxFrontend),
            "port": _Server(port(models), ApiServer, ServingFrontend),
            "port2": _Server(port(models), ApiServer, ServingFrontend)}
    yield pair
    for s in pair.values():
        s.close()


def test_kv_export_and_import_over_sockets(servers):
    """Export from the JAX server, import into the port's: the import
    adopts every page, and the port then serves the prompt spliced, with
    the JAX server's tokens."""
    js, ts = servers["jax"], servers["port"]
    req = {"prompt": PROMPT.tolist(), "max_tokens": 10}
    want = js.post("/v1/completions", json.dumps(req).encode())
    assert want[0] == 200
    st, exp = js.kv({"op": "export", "tokens": PROMPT.tolist()})
    assert st == 200 and exp["payload"] is not None
    st2, mine = ts.kv({"op": "export", "tokens": PROMPT.tolist()})
    assert (st2, mine) == (200, {"payload": None})  # nothing cached yet
    st, got = ts.kv({"op": "import", "payload": exp["payload"]})
    assert (st, got) == (200, {"adopted": PROMPT.size // 8})
    out = ts.post("/v1/completions", json.dumps(req).encode())
    assert out[0] == 200
    assert out[1]["choices"][0]["token_ids"] == \
        want[1]["choices"][0]["token_ids"]
    assert ts.frontend.engine._pcache.hits == 1
    # and the port's own export imports into another port engine
    st, exp2 = ts.kv({"op": "export", "tokens": PROMPT.tolist()})
    assert st == 200 and len(exp2["payload"]["pages"]) == PROMPT.size // 8
    assert servers["port2"].kv({"op": "import",
                                "payload": exp2["payload"]}) == \
        (200, {"adopted": PROMPT.size // 8})


@pytest.mark.parametrize("body,status,kind", [
    (b"{not json", 400, "invalid_json"),
    (json.dumps({"op": "evict"}).encode(), 400, "validation"),
    (json.dumps({"op": "import", "payload": {"page_size": 8, "pages": [[
        {"dtype": "float32", "shape": [2], "b64": "%%%"}]]}}).encode(),
     503, "kv_handoff"),
    (json.dumps({"op": "import", "payload": None}).encode(), 200, None),
])
def test_kv_errors_match_reference(servers, body, status, kind):
    got = {k: servers[k].post("/v1/kv", body) for k in ("jax", "port")}
    for st, js in got.values():
        assert st == status
        if kind is not None:
            assert js["error"]["type"] == kind
    assert got["port"][1].keys() == got["jax"][1].keys()
    if kind is None:
        assert got["port"][1] == got["jax"][1] == {"adopted": 0}


# ----------------------------------------------------------------- codec
def test_codec_round_trips_bf16_as_raw_words():
    g = torch.Generator().manual_seed(3)
    rows = [torch.randn((8, 32), generator=g).to(torch.bfloat16),
            torch.randn((8, 32), generator=g),
            torch.randint(-128, 127, (8, 128), dtype=torch.int8)]
    pay = {"tokens": [1, 2], "page_size": 8, "digests": ["x"],
           "pages": [rows], "dev_sums": [None], "nbytes": 1}
    wire = json.loads(json.dumps(encode_kv_payload(pay)))
    assert [d["dtype"] for d in wire["pages"][0]] == \
        ["bfloat16", "float32", "int8"]
    back = decode_kv_payload(wire)["pages"][0]
    for a, b in zip(rows, back):
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(
            torch.uint8), b.view(-1).view(torch.uint8))
    # the JAX codec reads the port's JSON to the same bits, and the port
    # reads the JAX codec's (bf16 through ml_dtypes there)
    theirs = jax_decode(wire)["pages"][0]
    for a, b in zip(rows, theirs):
        assert a.contiguous().view(-1).view(torch.uint8).numpy().tobytes() \
            == np.ascontiguousarray(b).tobytes()
    again = decode_kv_payload(json.loads(json.dumps(
        jax_encode(dict(pay, pages=[theirs])))))["pages"][0]
    for a, b in zip(rows, again):
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8))


def test_codec_needs_no_ml_dtypes():
    """The port's codec decodes bf16 with ``ml_dtypes`` unimportable."""
    code = (
        "import sys, json, base64\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch.serving.replica import (decode_kv_payload,"
        " encode_kv_payload)\n"
        "x = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)\n"
        "w = json.loads(json.dumps(encode_kv_payload({'pages': [[x]]})))\n"
        "y = decode_kv_payload(w)['pages'][0][0]\n"
        "assert torch.equal(x, y) and y.dtype == torch.bfloat16\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=WAIT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "ok"


def test_codec_bytes_equal_reference_for_f32():
    a = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    pay = {"pages": [[a]]}
    assert encode_kv_payload(pay)["pages"][0][0] == \
        jax_encode(pay)["pages"][0][0]
    got = decode_kv_payload(jax_encode(pay))["pages"][0][0]
    assert np.array_equal(got.numpy(), a)
    assert base64.b64decode(encode_kv_payload(
        {"pages": [[torch.from_numpy(a)]]})["pages"][0][0]["b64"]) == \
        a.tobytes()
