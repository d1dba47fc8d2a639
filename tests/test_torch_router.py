"""The port's multi-replica layer (``paddle_tpu_torch.serving.replica`` and
``router``) against paddle_tpu's, after ``tests/test_replica_failover.py``,
``tests/test_integrity.py``'s quarantine failover and
``tests/test_tracing.py``'s router span tests, on tiny LLaMA with the JAX
model's weights carried across (f32, ``page_size=8``, ``chunk_size=4``):

* ``ServingFrontend.poison()`` ends liveness without draining, as the JAX
  front end's does; with every replica dead, placement fails bounded with
  reason ``replica_lost`` on both routers.
* The ``replica-crash`` point kills a replica from the supervisor's sweep
  and its stream migrates to the reference's tokens.
* Failover with ``InProcReplica``s: a kill mid-stream, a seeded-sampled
  stream, a ``heartbeat-drop`` and a hedge each give the direct engine's
  stream, which equals the JAX engine's; the weight-audit quarantine
  fences a replica and its streams migrate exactly; a real SIGKILL of an
  ``examples/serve_llama_paged_torch.py`` worker. These are marked slow,
  as the reference marks them.
* A routed request's spans close, acyclic, under one root, with the JAX
  router's span names; its TTFT components partition the ``ttft`` span.
* The launch counters stay exact with two threads launching while one of
  them captures (a stand-in graph), and with two engines on two threads.

Every blocking wait carries its own timeout.
"""
import json
import os
import sys
import threading
import time
import urllib.request
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jsv
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.observability import metric_total as jax_metric
from paddle_tpu.observability.tracing import TRACER as JAX_TRACER
from paddle_tpu.observability.tracing import \
    configure_tracing as jax_configure_tracing

import paddle_tpu_torch.serving as tsv
from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference import runner as trunner
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import metric_total
from paddle_tpu_torch.observability.tracing import (
    TRACER, configure_tracing, ttft_decomposition_summary)
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 128
PROMPT = list(range(1, 21))
GEOM = dict(page_size=8, chunk_size=4)
WAIT = 180  # seconds any single blocking wait may take


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    return jm, {k: np.asarray(v) for k, v in param_arrays(jm).items()}


@pytest.fixture(scope="module")
def models(weights):
    return weights[0], llama_from_numpy(tiny_llama_config(), weights[1],
                                        device="cpu")


def make_engine(model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_pages", 64)
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    return Engine(model, device="cpu", **kw)


def make_jax_engine(model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_pages", 64)
    for k, v in GEOM.items():
        kw.setdefault(k, v)
    return JaxEngine(model, dtype=jnp.float32, **kw)


def _direct(models, budget=16, **kw):
    """PROMPT's stream from the JAX engine and from the port's, run
    directly; they must be equal."""
    out = []
    for make, model in ((make_jax_engine, models[0]),
                        (make_engine, models[1])):
        eng = make(model, chunk_size=1, max_chain=1)
        req = eng.add_request(np.asarray(PROMPT, np.int32), budget, **kw)
        eng.run()
        assert req.done and not req.failed
        out.append(list(req.tokens))
    assert out[0] == out[1]
    return out[1]


@pytest.fixture(scope="module")
def reference(models):
    """The unkilled greedy stream of PROMPT, 16 tokens: the identity target
    of every migrated stream."""
    return _direct(models)


def _slow_factory(model, delay_ms=30, **kw):
    def factory():
        return tsv.ServingFrontend(make_engine(
            model, chunk_size=1, max_chain=1,
            fault_plan=f"slow-step:every=1,delay_ms={delay_ms}", **kw))
    return factory


def _wait_tokens(ticket, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(ticket.tokens) >= n:
            return True
        time.sleep(0.02)
    return False


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ------------------------------------------------------ front-end chaos
def test_poison_kills_liveness_without_draining(models):
    """On both front ends: ``poison()`` ends liveness at the engine
    thread's next turn, the live ticket is neither finished nor failed
    (silence, by design), and the front end refuses new work."""
    got = []
    for fe in (jsv.ServingFrontend(make_jax_engine(models[0])),
               tsv.ServingFrontend(make_engine(models[1]))):
        fe.start()
        # a budget the model fits (20 + 100 <= 128 positions): the ticket
        # is live, not refused, whenever the engine thread takes it
        t = fe.submit(PROMPT, 100)
        fe.poison()
        assert _wait(lambda: not fe.alive, 10.0)
        assert not fe.readiness()["alive"]
        got.append((fe.alive, t.done, t.failure_reason))
        try:
            fe.submit(PROMPT, 4)
            refused = False
        except Exception as e:  # noqa: BLE001 - each package's QueueFull
            refused = type(e).__name__ == "QueueFull"
        got.append(refused)
        fe._thread.join(timeout=10.0)
        assert not fe._thread.is_alive()
    assert got[:2] == got[2:] == [(False, False, None), True]


def test_all_replicas_dead_fails_bounded(models):
    """No healthy replica: placement fails with reason ``replica_lost``
    after the bounded retry, on the port's router and the JAX one."""
    reasons = []
    for sv, factory, metric in (
            (jsv, lambda: jsv.ServingFrontend(make_jax_engine(models[0])),
             jax_metric),
            (tsv, lambda: tsv.ServingFrontend(make_engine(models[1])),
             metric_total)):
        reps = [sv.InProcReplica(factory, name=f"d{i}", index=i)
                for i in range(2)]
        router = sv.Router(reps, heartbeat_s=0.05, stall_s=None,
                           restart_dead=False, max_place_attempts=3,
                           place_backoff_s=0.01)
        router.start()
        try:
            for rep in reps:
                rep.kill()
            assert _wait(lambda: not any(r.alive() for r in reps), 10.0)
            f0 = metric("paddle_tpu_request_failures_total")
            t0 = time.monotonic()
            t = router.submit(PROMPT, 8)
            t.result(timeout=60)
            reasons.append((t.failure_reason, t.tokens,
                            metric("paddle_tpu_request_failures_total")
                            - f0))
            assert time.monotonic() - t0 < 5.0
        finally:
            router.shutdown()
    assert reasons[0] == reasons[1] == ("replica_lost", [], 1.0)


def _router(factories, **kw):
    reps = [tsv.InProcReplica(f, name=f"r{i}", index=i)
            for i, f in enumerate(factories)]
    kw.setdefault("heartbeat_s", 0.05)
    kw.setdefault("stall_s", None)
    return tsv.Router(reps, **kw), reps


def test_replica_crash_point_kills_and_migrates(models, reference):
    """``replica-crash:rid=0``: the supervisor's sweep kills replica 0 on
    its third check; the stream placed there migrates and ends as the
    reference, and nothing fails."""
    fails0 = metric_total("paddle_tpu_request_failures_total")
    router, reps = _router([_slow_factory(models[1])] * 2,
                           restart_dead=False,
                           fault_plan="replica-crash:rid=0,at=3")
    try:
        # placed before the monitor starts: the stream is on replica 0
        # when the third sweep kills it
        for r in reps:
            r.start()
        t = router.submit(PROMPT, 16)
        assert t.replica == "r0"
        router.start()
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None and t.migrations == 1
        assert not reps[0].alive() and reps[1].alive()
        assert metric_total("paddle_tpu_request_failures_total") == fails0
    finally:
        router.shutdown()


# -------------------------------------------------- router failover (slow)
@pytest.mark.slow
def test_kill_mid_stream_is_bit_identical(models, reference):
    """Two replicas; the one hosting the stream is poisoned mid-flight:
    the client sees ONE unbroken stream, the reference's, with no
    duplicates or gaps; zero request failures; the dead replica restarts
    under supervision and comes back ready."""
    fails0 = metric_total("paddle_tpu_request_failures_total")
    router, reps = _router([_slow_factory(models[1])] * 2,
                           restart_dead=True, restart_backoff_s=0.05)
    router.start()
    try:
        chunks = []
        t = router.submit(PROMPT, 16, on_chunk=lambda c: chunks.append(c))
        assert _wait_tokens(t, 4), t.tokens
        assert len(t.tokens) < 16, "stream finished before the kill"
        victim = next(r for r in reps if r.name == t.replica)
        dead = weakref.ref(victim.frontend.engine)
        victim.kill()
        assert t.result(timeout=WAIT) == reference
        assert t.migrations >= 1 and t.failure_reason is None
        flat = [tok for c in chunks if c for tok in c]
        assert flat == reference and chunks[-1] is None
        assert metric_total("paddle_tpu_request_failures_total") == fails0
        assert metric_total("paddle_tpu_router_migrations_total") >= 1
        assert _wait(lambda: victim.alive() and victim.restarts >= 1, 90)
        assert victim.ready()["ready"]
        assert metric_total("paddle_tpu_replica_restarts_total") >= 1
        # the restart dropped the dead engine (its pool and graphs) before
        # the fresh one was built
        assert dead() is None
    finally:
        router.shutdown()


@pytest.mark.slow
def test_sampled_stream_migrates_exactly(models):
    """A seeded-sampled stream resumes through the replayed key schedule:
    the migrated stream equals the direct run's, which equals the JAX
    engine's."""
    sref = _direct(models, temperature=0.7, seed=42)
    router, reps = _router([_slow_factory(models[1])] * 2,
                           restart_dead=False)
    router.start()
    try:
        t = router.submit(PROMPT, 16, temperature=0.7, seed=42)
        assert _wait_tokens(t, 4) and len(t.tokens) < 16
        next(r for r in reps if r.name == t.replica).kill()
        assert t.result(timeout=WAIT) == sref
        assert t.migrations >= 1 and t.failure_reason is None
    finally:
        router.shutdown()


@pytest.mark.slow
def test_heartbeat_drop_migrates_without_kill(models, reference):
    """``heartbeat-drop``: replica 0 is fine, but the router must treat it
    as dead, cancel its stream first (no double delivery) and resume
    elsewhere, still the reference's stream."""
    router, _ = _router([_slow_factory(models[1])] * 2, restart_dead=False,
                        fault_plan="heartbeat-drop:rid=0,at=5,times=60")
    router.start()
    try:
        ta = router.submit(PROMPT, 16)
        tb = router.submit(PROMPT, 16)
        assert ta.result(timeout=WAIT) == reference
        assert tb.result(timeout=WAIT) == reference
        assert ta.failure_reason is None and tb.failure_reason is None
        assert ta.migrations + tb.migrations >= 1
    finally:
        router.shutdown()


@pytest.mark.slow
def test_hedge_rescues_slow_first_token(models, reference):
    """The single hedge: replica 0 is far slower than ``hedge_ms`` to its
    first token, the hedge on replica 1 wins, and the stream is the
    reference's."""
    h0 = metric_total("paddle_tpu_router_hedges_total")
    router, _ = _router([_slow_factory(models[1], delay_ms=700),
                         _slow_factory(models[1], delay_ms=10)],
                        restart_dead=False, hedge_ms=400.0)
    router.start()
    try:
        t = router.submit(PROMPT, 8)
        out = t.result(timeout=WAIT)
        assert out == reference[:8] and t.failure_reason is None
        assert t.hedged
        assert metric_total("paddle_tpu_router_hedges_total") > h0
    finally:
        router.shutdown()


@pytest.mark.slow
def test_weight_audit_failure_drains_replica_zero_failures(weights,
                                                            models):
    """Replica 0's weight audit fails mid-stream (``bit-flip-weight``):
    ``/readyz``'s ``quarantined`` makes the router fence it, migrate its
    streams exactly and restart it with verified weights. Each incarnation
    owns its model (the flip writes in place), made from the same weights;
    zero failed requests."""
    reference = _direct(models)

    def factory(plan):
        def make():
            model = llama_from_numpy(tiny_llama_config(), weights[1],
                                     device="cpu")
            return tsv.ServingFrontend(make_engine(
                model, chunk_size=1, max_chain=1, fault_plan=plan,
                integrity={"mode": "audit", "weight_audit_every": 1}))
        return make

    fails0 = metric_total("paddle_tpu_request_failures_total")
    q0 = metric_total("paddle_tpu_replica_quarantines_total")
    slow = "slow-step:every=1,delay_ms=30"
    router, _ = _router([factory(f"{slow};bit-flip-weight:at=4"),
                         factory(slow)],
                        restart_dead=True, restart_backoff_s=0.05)
    router.start()
    try:
        t0 = router.submit(PROMPT, 16)
        t1 = router.submit(PROMPT, 16)
        assert t0.result(timeout=WAIT) == reference
        assert t1.result(timeout=WAIT) == reference
        assert t0.failure_reason is None and t1.failure_reason is None
        assert metric_total("paddle_tpu_replica_quarantines_total") > q0
        assert t0.migrations + t1.migrations >= 1
        assert metric_total("paddle_tpu_request_failures_total") == fails0
    finally:
        router.shutdown()


# ------------------------------------------------------------ router spans
@pytest.fixture
def tracing():
    """Both tracers on for the test, off and cleared after it (other tests
    must never see a configured tracer)."""
    caps = TRACER.capacity, JAX_TRACER.capacity
    configure_tracing("on", process="test")
    jax_configure_tracing("on", process="test")
    TRACER.clear()
    JAX_TRACER.clear()
    yield
    TRACER.flight_dir = None
    JAX_TRACER.flight_dir = None
    configure_tracing("off", process="main", capacity=caps[0])
    jax_configure_tracing("off", process="main", capacity=caps[1])
    TRACER.clear()
    JAX_TRACER.clear()


def _serve_traced(sv, factory, tracer, budget=8):
    reps = [sv.InProcReplica(factory, name="t0", index=0)]
    router = sv.Router(reps, heartbeat_s=0.05, stall_s=None,
                       restart_dead=False)
    router.start()
    try:
        t = router.submit(PROMPT, budget)
        out = t.result(timeout=WAIT)
        assert _wait(lambda: tracer.open_spans == 0, 10.0), \
            "open spans leaked"
        return t, out, tracer.snapshot()
    finally:
        router.shutdown()


def test_routed_request_spans_close_acyclically_like_reference(
        models, reference, tracing):
    """A routed request's spans all close, ids are unique, parent chains
    never cycle, the root ``request`` span carries its outcome, and the
    span names are the JAX router's on the same request."""
    _, jout, jsnap = _serve_traced(
        jsv, lambda: jsv.ServingFrontend(make_jax_engine(models[0])),
        JAX_TRACER)
    t, out, snap = _serve_traced(
        tsv, lambda: tsv.ServingFrontend(make_engine(models[1])), TRACER)
    assert out == jout == reference[:8]
    assert snap, "tracing on recorded nothing"
    by_id = {r["id"]: r for r in snap}
    assert len(by_id) == len(snap), "span ids collide"
    for rec in snap:
        seen, cur = set(), rec
        while cur is not None and cur.get("parent"):
            assert cur["id"] not in seen, "parent cycle"
            seen.add(cur["id"])
            cur = by_id.get(cur["parent"])
    roots = [r for r in snap if r["name"] == "request"]
    assert len(roots) == 1 and roots[0]["dur"] is not None
    assert roots[0]["args"]["tokens"] == 8
    router_names = {r["name"] for r in snap
                    if r["name"].startswith(("request", "router.",
                                             "frontend.", "ttft"))}
    assert router_names == {r["name"] for r in jsnap
                            if r["name"].startswith(("request", "router.",
                                                     "frontend.", "ttft"))}
    assert t.ttft_s is not None


def test_ttft_components_partition_the_ttft_span(models, tracing):
    """Through the router, the first token's components (placement, queue
    wait, promote wait, prefill) partition the ``ttft`` span exactly and
    nest under the request root; the host's TTFT agrees with it."""
    t, _, snap = _serve_traced(
        tsv, lambda: tsv.ServingFrontend(make_engine(models[1])), TRACER)
    ttfts = [r for r in snap if r["name"] == "ttft"]
    assert len(ttfts) == 1
    ttft = ttfts[0]
    comps = {r["name"]: r["dur"] for r in snap
             if r["name"].startswith("ttft.")}
    assert set(comps) == {"ttft.placement", "ttft.queue_wait",
                          "ttft.promote_wait", "ttft.prefill"}
    assert abs(sum(comps.values()) - ttft["dur"]) < 1e-6
    root = next(r for r in snap if r["name"] == "request")
    assert ttft["trace"] == root["trace"] and ttft["parent"] == root["id"]
    assert abs(ttft["dur"] - t.ttft_s) < 0.25
    d = ttft_decomposition_summary()
    assert d and d["n"] >= 1
    fracs = sum(v for k, v in d.items() if k.endswith("_frac"))
    assert abs(fracs - 1.0) < 1e-6


@pytest.mark.slow
def test_killed_stream_renders_as_one_contiguous_trace(models, reference,
                                                       tracing, tmp_path):
    """A migrated stream is ONE trace across both replicas: both
    placements, both front-end admissions and the migration itself."""
    TRACER.flight_dir = str(tmp_path)
    router, reps = _router([_slow_factory(models[1])] * 2,
                           restart_dead=False)
    router.start()
    try:
        t = router.submit(PROMPT, 16)
        assert _wait_tokens(t, 4), t.tokens
        assert len(t.tokens) < 16, "stream finished before the kill"
        next(r for r in reps if r.name == t.replica).kill()
        assert t.result(timeout=WAIT) == reference
        assert t.migrations >= 1 and t.failure_reason is None
        assert _wait(lambda: TRACER.open_spans == 0, 10.0)
        snap = TRACER.snapshot()
        root = next(r for r in snap if r["name"] == "request")
        names = [r["name"] for r in snap if r["trace"] == root["trace"]]
        assert names.count("router.place") >= 2
        assert names.count("frontend.submit") >= 2
        assert names.count("engine.enqueue") >= 2
        assert "router.migrate" in names
        assert root["args"]["migrations"] >= 1
    finally:
        router.shutdown()


# ------------------------------------------------ launch counters, threads
class _StandInGraph:
    """A CUDA graph's bookkeeping on the CPU: the capture runs the body's
    Python once (its launches go to the capturing thread's tally); a
    replay runs the body with its launches tallied apart, as a replay runs
    kernels and no wrapper."""

    def __init__(self, owner):
        self.body = None

    def warm_up(self, body):
        body()

    def capture(self, body):
        body()
        self.body = body

    def replay(self):
        with build.tally_launches():
            self.body()


def test_launch_counters_exact_while_another_thread_captures():
    """One thread launches eagerly while another captures and replays
    steps of ``k`` launches, with the interpreter switching threads every
    few microseconds: every capture records exactly its own ``k`` (none of
    the other thread's launches), and the counter ends at the eager
    launches plus each step's warm-up and replays, to the launch."""
    fn = pa.paged_slab_decode_attention
    eager_n, steps, k, runs = 4000, 40, 3, 5

    def body():
        for _ in range(k):
            build.count_launch(fn)

    start = threading.Barrier(2, timeout=30)
    deltas, errors = [], []

    def eager():
        try:
            start.wait()
            for _ in range(eager_n):
                build.count_launch(fn)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    def capturer():
        try:
            start.wait()
            for _ in range(steps):
                step = trunner.CapturedStep(body, None,
                                            graph=_StandInGraph(None))
                deltas.append(step.deltas)
                step.run(runs)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    c0 = fn.launches
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=eager),
                   threading.Thread(target=capturer)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert deltas == [((fn, "launches", k),)] * steps
    assert fn.launches - c0 == eager_n + steps * k * (1 + runs)


@pytest.fixture
def stand_in(monkeypatch):
    """Engines capture into ``_StandInGraph``; the plain twins of #1 and #3
    count their calls as the kernels count launches."""
    monkeypatch.setattr(trunner, "_graph_factory",
                        lambda device: _StandInGraph)
    real_dec = pa.paged_slab_decode_attention_ref
    real_ver = pa.paged_verify_slab_attention_ref

    def dec(*a, **kw):
        build.count_launch(pa.paged_slab_decode_attention)
        return real_dec(*a, **kw)

    def ver(*a, **kw):
        build.count_launch(pa.paged_verify_slab_attention)
        return real_ver(*a, **kw)

    monkeypatch.setattr(pa, "paged_slab_decode_attention_ref", dec)
    monkeypatch.setattr(pa, "paged_verify_slab_attention_ref", ver)


def _counts():
    return (pa.paged_slab_decode_attention.launches,
            pa.paged_verify_slab_attention.launches)


def test_two_engines_on_two_threads_keep_counts_exact(models, stand_in):
    """Two engines (one plain, one spec) step on two threads, each
    capturing its decode and verify steps while the other launches: the
    counters end where the two engines' runs one after the other end, and
    each engine's streams are its own run's alone."""
    rng = np.random.default_rng(4)
    items = [rng.integers(0, VOCAB, (int(rng.integers(6, 30)),))
             for _ in range(5)]

    def engines():
        a = make_engine(models[1], max_chain=4)
        b = make_engine(models[1], max_chain=2, spec="ngram", spec_k=2)
        for e in (a, b):
            e._cost_pin = 8.0  # chain depths independent of the wall
        return a, b

    def serve(eng):
        reqs = [eng.add_request(p, 12) for p in items]
        eng.run()
        return [list(r.tokens) for r in reqs]

    c0 = _counts()
    want = [serve(e) for e in engines()]
    alone = [a - b for a, b in zip(_counts(), c0)]
    assert all(alone)

    got, errors = [None, None], []
    pair = engines()
    start = threading.Barrier(2, timeout=30)

    def run(i):
        try:
            start.wait()
            got[i] = serve(pair[i])
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    c0 = _counts()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert got == want
    assert [a - b for a, b in zip(_counts(), c0)] == alone
    layers = models[1].config.num_layers
    for eng in pair:
        for (key, _), step in eng.runner._graphs.steps.items():
            counter = (pa.paged_slab_decode_attention if key[0] == "decode"
                       else pa.paged_verify_slab_attention)
            assert step.deltas == ((counter, "launches", layers),)


# ---------------------------------------------------- subprocess (chaos)
@pytest.mark.slow
def test_sigkill_mid_stream_bit_identical():
    """Two ``serve_llama_paged_torch.py --tiny --device cpu`` workers
    behind the router; one gets a real SIGKILL mid-stream. Every in-flight
    greedy stream equals an unkilled worker's own stream (both workers
    make their weights from seed 0), with zero request failures, and the
    supervised restart brings the worker back ready."""
    fails0 = metric_total("paddle_tpu_request_failures_total")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    argv = [sys.executable, "-u",
            os.path.join(REPO, "examples", "serve_llama_paged_torch.py"),
            "--tiny", "--device", "cpu", "--api-port", "0",
            "--fault-inject", "slow-step:every=1,delay_ms=120"]
    reps = [tsv.SubprocessReplica(argv, name=f"w{i}", index=i, env=env,
                                  cwd=REPO) for i in range(2)]
    router = tsv.Router(reps, heartbeat_s=0.1, stall_s=None,
                        restart_dead=True, restart_backoff_s=0.1)
    router.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{reps[1].port}/v1/completions",
            data=json.dumps({"prompt": PROMPT, "max_tokens": 40}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            ref = json.loads(r.read())["choices"][0]["token_ids"]
        assert len(ref) == 40
        ta = router.submit(PROMPT, 40)
        tb = router.submit(PROMPT, 40)
        assert _wait_tokens(ta, 8, 180) and _wait_tokens(tb, 8, 180)
        assert len(ta.tokens) < 40, "stream finished before the kill"
        victim = next(r for r in reps if r.name == ta.replica)
        victim.kill()  # a real SIGKILL
        assert ta.result(timeout=300) == ref
        assert tb.result(timeout=300) == ref
        assert ta.failure_reason is None and tb.failure_reason is None
        assert ta.migrations >= 1
        assert metric_total("paddle_tpu_request_failures_total") == fails0
        assert _wait(lambda: victim.alive() and victim.restarts >= 1, 180)
        assert _wait(lambda: victim.ready().get("ready"), 60)
    finally:
        router.shutdown()
