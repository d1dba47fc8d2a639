"""The port's serving surface on the engine against paddle_tpu's ``Engine``
on tiny LLaMA with the same weights (f32, ``page_size=8``,
``chunk_size=4``): ``step(n)`` and ``multi_step``, ``cancel``, deadlines,
``max_queue``, whole-step fault recovery, the watchdog, metrics and
tracing. The same numpy prompts and seeds go to both engines; token
streams must be identical (exact integer equality, no tolerance), and the
port's counters and histogram counts must equal the reference's deltas
(times are not compared).

The JAX engine runs as its own tests run it on the CPU. Both packages keep
their own process-global registry and tracer, so each side is read in its
own.
"""
import glob
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.errors import QueueFull as JaxQueueFull
from paddle_tpu.inference.watchdog import Watchdog as JaxWatchdog
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.observability import REGISTRY as JAX_REGISTRY
from paddle_tpu.observability.tracing import TRACER as JAX_TRACER

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.errors import QueueFull
from paddle_tpu_torch.inference.watchdog import Watchdog
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.observability.tracing import TRACER

GEOM = dict(page_size=8, chunk_size=4)
VOCAB = 128


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


def _jax(models, max_slots=3, num_pages=64, **kw):
    return JaxEngine(models[0], max_slots=max_slots, num_pages=num_pages,
                     dtype=jnp.float32, **GEOM, **kw)


def _port(models, max_slots=3, num_pages=64, **kw):
    return Engine(models[1], max_slots=max_slots, num_pages=num_pages,
                  device="cpu", **GEOM, **kw)


def _items(lens, budgets, temps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (n,)), m, t, 11 + i)
            for i, (n, m, t) in enumerate(zip(lens, budgets, temps))]


def _add(eng, items, **kw):
    return [eng.add_request(p, m, temperature=t, seed=s, **kw)
            for p, m, t, s in items]


def _drive(eng, n=None, limit=500, faults=False):
    """Step ``eng`` (either package's) until it drains. Unless the test
    injects ``faults``, fail on any step fault the engine recovered from:
    the recovered run can give the right streams all the same."""
    for _ in range(limit):
        if not eng.step(n):
            break
    else:
        raise AssertionError("engine did not drain")
    if not faults:
        assert eng._watchdog.last_fault is None, eng._watchdog.last_fault


def _tokens(reqs):
    return [list(r.tokens) for r in reqs]


# ------------------------------------------------------------ step(n)
WORKLOADS = {
    # queue empty after the first admission: the multi-step fast path runs
    "greedy": dict(lens=(5, 9, 12), budgets=(21, 13, 30),
                   temps=(0.0, 0.0, 0.0)),
    "sampled": dict(lens=(7, 4, 10), budgets=(18, 26, 11),
                    temps=(0.8, 0.0, 1.2)),
    # a 12-page pool: the chains outgrow it and the longest is preempted
    "preempt": dict(lens=(8, 8, 8), budgets=(50, 50, 50),
                    temps=(0.0, 0.7, 0.0), num_pages=13),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_step_n_matches_single_steps_and_reference(models, name):
    """``multi_step=4`` (step() with no n), ``step(4)`` on a multi_step=1
    engine, and ``step(1)`` give the same streams on the port, equal to
    the JAX engine driven by ``step(4)``."""
    w = dict(WORKLOADS[name])
    # chains of at most 2 x 4 tokens: every request needs several
    geo = dict(num_pages=w.pop("num_pages", 64), max_chain=2)
    items = _items(w["lens"], w["budgets"], w["temps"])
    streams, engines = {}, {}
    for tag, kw, n in (("single", {}, 1), ("multi", dict(multi_step=4), None),
                       ("explicit", {}, 4)):
        eng = _port(models, **geo, **kw)
        h0 = REGISTRY.get("paddle_tpu_engine_steps_per_roundtrip")
        before = (h0.count, h0.sum) if h0 is not None else (0, 0.0)
        reqs = _add(eng, items)
        _drive(eng, n)
        assert all(r.done and not r.failed for r in reqs), \
            [(r.failure_reason, r.failure) for r in reqs]
        h = REGISTRY.get("paddle_tpu_engine_steps_per_roundtrip")
        engines[tag] = (eng, h.count - before[0], h.sum - before[1])
        streams[tag] = _tokens(reqs)
    je = _jax(models, **geo)
    jr = _add(je, items)
    _drive(je, 4)
    assert all(r.done and not r.failed for r in jr)
    assert streams["single"] == streams["multi"] == streams["explicit"]
    assert streams["single"] == _tokens(jr)
    for tag in ("multi", "explicit"):
        _, steps, iters = engines[tag]
        assert iters > steps, f"{tag}: the multi-step path never engaged"
    _, steps, iters = engines["single"]
    assert iters == steps
    if name == "preempt":
        assert all(engines[t][0].preemptions > 0 for t in engines)
    for eng, *_ in engines.values():
        assert len(eng._free_pages) == eng.num_pages - 1
        assert not eng._active and not eng._queue


# ------------------------------------------------------------- cancel
def test_cancel_mid_decode_and_queued_matches_reference(models):
    """One active and one queued request cancelled after the first step:
    both end ``cancelled`` with the same free-page count on both sides,
    and the co-batched stream is unchanged."""
    items = _items((6, 9, 5), (44, 44, 44), (0.0, 0.9, 0.0), seed=3)
    got = []
    for eng in (_jax(models, max_slots=2), _port(models, max_slots=2)):
        reqs = _add(eng, items)
        eng.step()
        assert reqs[0].slot is not None and reqs[2].slot is None
        assert eng.cancel(reqs[0].rid) and eng.cancel(reqs[2].rid)
        assert not eng.cancel(reqs[0].rid)  # already terminal
        free_after = len(eng._free_pages)
        _drive(eng)
        got.append(([r.failure_reason for r in reqs], free_after,
                    _tokens(reqs), len(eng._free_pages)))
    assert got[0][0] == got[1][0] == ["cancelled", None, "cancelled"]
    assert got[0][1] == got[1][1]
    assert got[0][2] == got[1][2]
    assert got[0][3] == got[1][3] == 63


# ---------------------------------------------- deadlines and the queue
def test_zero_deadline_fails_at_first_step(models):
    """A zero deadline, per request or engine-wide, fails with reason
    ``deadline`` at the first step on both sides; the others finish."""
    items = _items((5, 7, 6), (6, 6, 6), (0.0, 0.0, 0.0), seed=4)
    got = []
    for eng in (_jax(models, deadline_s=0.0), _port(models, deadline_s=0.0)):
        late = _add(eng, items[:1])
        ok = _add(eng, items[1:], deadline_s=60.0)
        eng.step()
        assert late[0].failure_reason == "deadline" and not late[0].tokens
        _drive(eng)
        got.append(([r.failure_reason for r in late + ok],
                    _tokens(late + ok)))
    assert got[0] == got[1]
    assert got[1][0] == ["deadline", None, None]


def test_max_queue_raises_at_same_count(models):
    """``max_queue=3``: the fourth submission raises ``QueueFull`` (reason
    ``queue_full``) on both sides, and it counts as a rejection."""
    items = _items((4, 5, 6, 7, 8), (3,) * 5, (0.0,) * 5, seed=5)
    counts = []
    for eng, exc, reg in ((_jax(models, max_queue=3), JaxQueueFull,
                           JAX_REGISTRY),
                          (_port(models, max_queue=3), QueueFull, REGISTRY)):
        rej0 = _total(reg, "paddle_tpu_admission_rejected_total")
        n = 0
        with pytest.raises(exc) as info:
            for p, m, t, s in items:
                eng.add_request(p, m, temperature=t, seed=s)
                n += 1
        assert info.value.reason == "queue_full"
        assert isinstance(info.value, ValueError)
        counts.append((n, _total(reg, "paddle_tpu_admission_rejected_total")
                       - rej0))
        _drive(eng)
    assert counts[0] == counts[1] == (3, 1.0)


# ----------------------------------------------------------- recovery
def _dying(get, calls_to_fail):
    """Wrap a ``get_decode``-style factory so the decode dispatches whose
    ordinal (from 1) is in ``calls_to_fail`` raise."""
    seen = {"n": 0}

    def factory(*a, **kw):
        fn = get(*a, **kw)

        def decode(*args, **kwargs):
            seen["n"] += 1
            if seen["n"] in calls_to_fail:
                raise RuntimeError("injected dispatch fault")
            return fn(*args, **kwargs)

        return decode

    return factory


@pytest.mark.parametrize("fail", [(2,), (2, 3, 4)], ids=["once", "thrice"])
def test_dispatch_fault_recovers_like_reference(models, fail):
    """A decode dispatch raising mid-run (once; three times in a row): step
    never raises, every request finishes with the fault-free streams, one
    recovery is counted per fault, and the watchdog reads the same on
    both sides (three faults: one level down, ``no-spec``, still ready)."""
    items = _items((6, 8, 5, 9), (14, 10, 12, 9), (0.0, 0.6, 0.0, 0.0),
                   seed=6)
    clean = _jax(models, max_slots=2)
    want = _add(clean, items)
    _drive(clean)
    je = _jax(models, max_slots=2)
    je._get_decode = _dying(je._get_decode, set(fail))
    te = _port(models, max_slots=2)
    te.runner.get_decode = _dying(te.runner.get_decode, set(fail))
    out = []
    for eng, reg in ((je, JAX_REGISTRY), (te, REGISTRY)):
        rec0 = _total(reg, "paddle_tpu_engine_recoveries_total")
        reqs = _add(eng, items)
        _drive(eng, faults=True)
        assert all(r.done and not r.failed for r in reqs)
        out.append((_tokens(reqs), eng._watchdog.readiness(),
                    _total(reg, "paddle_tpu_engine_recoveries_total") - rec0,
                    len(eng._free_pages)))
        assert isinstance(eng._watchdog.last_fault, RuntimeError)
    assert out[0] == out[1]
    assert out[1][0] == _tokens(want)
    assert out[1][2] == len(fail)
    level = 1 if len(fail) >= 3 else 0
    assert out[1][1] == {"ready": True, "level": level,
                         "mode": ("no-spec" if level else "healthy"),
                         "quarantined": False}


def test_prefill_fault_requeues_the_wave(models, monkeypatch):
    """A fault in the admission prefill (the wave popped from the queue but
    not yet active) requeues the whole wave; nothing is lost."""
    items = _items((6, 8, 5), (7, 9, 6), (0.0, 0.0, 0.5), seed=7)
    te = _port(models)
    want = _port(models)
    wr = _add(want, items)
    _drive(want)
    orig = te.runner.get_prefill
    state = {"armed": True}

    def get_prefill(*a, **kw):
        fn = orig(*a, **kw)

        def prefill(*args, **kwargs):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected prefill fault")
            return fn(*args, **kwargs)

        return prefill

    monkeypatch.setattr(te.runner, "get_prefill", get_prefill)
    reqs = _add(te, items)
    te.step()  # the faulted step: nothing admitted, nothing lost
    assert len(te._queue) == 3 and not te._active
    assert all(r.retries == 1 for r in reqs)
    _drive(te, faults=True)
    assert _tokens(reqs) == _tokens(wr)


def test_unusable_device_context_reraises(models, monkeypatch):
    """A fault that leaves the device context unusable is not recovered:
    ``step`` re-raises it (on the card: an illegal address)."""
    te = _port(models)
    te.runner.get_decode = _dying(te.runner.get_decode, {1})
    monkeypatch.setattr(te, "_context_usable", lambda: False)
    _add(te, _items((5,), (9,), (0.0,)))
    with pytest.raises(RuntimeError, match="injected dispatch fault"):
        te.step()


def test_step_keeps_autograd_off_on_another_thread(models):
    """Grad mode is per thread: an engine stepped from a thread with grad
    mode on records no autograd graph (no page or output has a grad_fn)."""
    te = _port(models)
    assert any(p.requires_grad for p in models[1].parameters())
    reqs = _add(te, _items((6, 9), (9, 7), (0.0, 0.7)))
    box = {}

    def run():
        torch.set_grad_enabled(True)
        try:
            _drive(te)
        except BaseException as e:  # noqa: BLE001 - reported below
            box["exc"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "exc" not in box
    assert all(r.done and not r.failed for r in reqs)
    for p in te._cache.k_pages + te._cache.v_pages:
        assert p.grad_fn is None and not p.requires_grad


# ------------------------------------------------------------ watchdog
class _StubEngine:
    def __init__(self, max_slots=8):
        self.max_slots = max_slots
        self._m = None
        self._spec_enabled = None
        self._slot_cap = None


def _script(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15:
            out.append(("fault",))
        elif r < 0.25:
            out.append(("drafter_fault",))
        elif r < 0.3:
            out.append(("drafter_ok",))
        elif r < 0.55:
            p = int(rng.integers(0, 8))
            out.append(("accept", p, int(rng.integers(0, p + 1))
                        if rng.random() < 0.3 else 0))
        else:
            out.append(("ok",))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_watchdog_state_machine_matches_reference(seed):
    """The same event sequence into both ``Watchdog`` classes (stub
    engines): mode, level, readiness and the two knobs the scheduler obeys
    agree after every event."""
    kw = dict(step_fault_threshold=2, drafter_fault_threshold=2,
              accept_floor=0.2, accept_window=4, recover_after=5)
    js, ts = _StubEngine(), _StubEngine()
    jw, tw = JaxWatchdog(js, **kw), Watchdog(ts, **kw)
    levels = set()
    for ev in _script(seed):
        for w in (jw, tw):
            if ev[0] == "fault":
                w.note_step_fault(RuntimeError("x"))
            elif ev[0] == "drafter_fault":
                w.note_drafter_fault()
            elif ev[0] == "drafter_ok":
                w.note_drafter_ok()
            elif ev[0] == "accept":
                w.note_acceptance(ev[1], ev[2])
            else:
                w.note_step_ok()
        assert (tw.mode, tw.level, tw.readiness(), ts._spec_enabled,
                ts._slot_cap) == (jw.mode, jw.level, jw.readiness(),
                                  js._spec_enabled, js._slot_cap), ev
        levels.add(tw.level)
    assert len(levels) > 1  # the script moved the state machine
    jw.quarantine()
    tw.quarantine()
    assert tw.readiness() == jw.readiness()
    assert tw.readiness()["ready"] is False


@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0), (0.0, 0.9, 0.0)],
                         ids=["greedy", "sampled"])
def test_spec_acceptance_collapse_degrades_like_reference(models, temps):
    """Spec decoding on both sides with the same live watchdog (a 4-step
    window, a 0.9 floor random weights never reach): both turn spec off
    at the same verify step and decode on vanilla chains, with identical
    streams."""
    rng = np.random.default_rng(12)
    span = rng.integers(0, VOCAB, (5,))
    prompts = [np.tile(span, 3), rng.integers(0, VOCAB, (9,)),
               np.concatenate([span, span[:3]])]
    wd = dict(accept_window=4, accept_floor=0.9)
    out = []
    for eng in (_jax(models, spec="ngram", spec_k=3, watchdog=wd),
                _port(models, spec="ngram", spec_k=3, watchdog=wd)):
        reqs = [eng.add_request(p, 20, temperature=t, seed=40 + i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        _drive(eng)
        assert all(r.done and not r.failed for r in reqs)
        out.append((_tokens(reqs), eng._watchdog.readiness(),
                    eng._spec.verify_steps, eng._spec_enabled))
    assert out[0] == out[1]
    assert out[1][1]["mode"] == "no-spec" and out[1][3] is False
    assert out[1][2] >= 4


# ------------------------------------------------------------- metrics
def _total(reg, name):
    m = reg.get(name)
    if m is None:
        return 0.0
    return float(sum(leaf.value for _, leaf in m.series()))


COUNTERS = (
    "paddle_serving_requests_total",
    "paddle_serving_requests_completed_total",
    "paddle_serving_tokens_total",
    "paddle_serving_preemptions_total",
    "paddle_tpu_request_failures_total",
    "paddle_tpu_admission_rejected_total",
    "paddle_tpu_request_retries_total",
    "paddle_tpu_prefix_cache_hits_total",
    "paddle_tpu_prefix_cache_misses_total",
    "paddle_tpu_prefix_cached_prefill_tokens_total",
    "paddle_tpu_prefix_computed_prefill_tokens_total",
    "paddle_serving_chain_depth_total",
    "paddle_serving_compiled_programs_total",
)
HISTOGRAMS = (
    "paddle_serving_ttft_seconds",
    "paddle_serving_queue_wait_seconds",
    "paddle_serving_tpot_seconds",
    "paddle_serving_prefill_batch_size",
    "paddle_serving_decode_batch_size",
    "paddle_tpu_engine_steps_per_roundtrip",
    "paddle_serving_step_seconds",
    "paddle_serving_ttft_component_seconds",
)
SUMS = ("paddle_serving_prefill_batch_size",
        "paddle_serving_decode_batch_size",
        "paddle_tpu_engine_steps_per_roundtrip")


def _read(reg):
    """{(metric, labels): value} for the counters, and count (and, for the
    size histograms, sum) for the histograms."""
    out = {}
    for name in COUNTERS:
        m = reg.get(name)
        for key, leaf in (m.series() if m is not None else ()):
            out[(name, key)] = leaf.value
    for name in HISTOGRAMS:
        m = reg.get(name)
        for key, leaf in (m.series() if m is not None else ()):
            out[(name, key, "count")] = leaf.count
            if name in SUMS:
                out[(name, key, "sum")] = leaf.sum
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


@pytest.mark.parametrize("multi", [1, 4], ids=["ms1", "ms4"])
def test_metrics_match_reference(models, multi):
    """After the same ``Engine.run`` workload (prefix-cache hits, a
    tenant, a sampled request, a deadline failure, a cancel), the port's
    counters and histogram counts equal the JAX registry's deltas."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, VOCAB, (16,))
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, (n,))])
               for n in (3, 5)] + [rng.integers(0, VOCAB, (7,))]
    deltas = []
    for eng, reg in ((_jax(models, prefix_cache=True, multi_step=multi),
                      JAX_REGISTRY),
                     (_port(models, prefix_cache=True, multi_step=multi),
                      REGISTRY)):
        before = _read(reg)
        first = eng.add_request(prompts[0], 10, tenant="interactive")
        eng.run()
        reqs = [eng.add_request(p, 12, temperature=0.5 * i, seed=i,
                                tenant="batch")
                for i, p in enumerate(prompts)]
        late = eng.add_request(prompts[2], 5, deadline_s=0.0)
        gone = eng.add_request(prompts[1], 5)
        eng.cancel(gone.rid)
        eng.run()
        assert first.done and all(r.done and not r.failed for r in reqs)
        assert late.failure_reason == "deadline"
        deltas.append(_delta(_read(reg), before))
    jd, td = deltas
    assert td == jd
    assert td[("paddle_serving_requests_completed_total", ())] == 4
    assert td[("paddle_tpu_request_failures_total",
               ("cancelled", "default"))] == 1
    assert td[("paddle_tpu_prefix_cache_hits_total", ())] >= 1
    assert td[("paddle_serving_ttft_seconds", ("batch",), "count")] == 3


def test_metrics_off_records_nothing(models):
    before = _read(REGISTRY)
    te = _port(models, metrics=False)
    assert te._m is None
    _add(te, _items((5, 6), (4, 4), (0.0, 0.0)))
    _drive(te)
    assert _delta(_read(REGISTRY), before) == {}


# ------------------------------------------------------------- tracing
@pytest.fixture
def tracing(tmp_path):
    for tr in (JAX_TRACER, TRACER):
        tr.configure("on", flight_dir=str(tmp_path))
        tr.clear()
    yield tmp_path
    for tr in (JAX_TRACER, TRACER):
        tr.configure("off")
        tr.clear()


def test_tracing_spans_match_reference(models, tracing):
    """With tracing on, the same workload (prefix cache, a traced request,
    a sampled one) leaves the same span and event names and categories in
    both tracers' rings, and no span open."""
    items = _items((9, 6, 11), (8, 10, 6), (0.0, 0.8, 0.0), seed=9)
    names = []
    for eng, tr in ((_jax(models, prefix_cache=True), JAX_TRACER),
                    (_port(models, prefix_cache=True), TRACER)):
        tr.clear()
        reqs = [eng.add_request(p, m, temperature=t, seed=s,
                                trace="feed/beef" if i == 0 else None)
                for i, (p, m, t, s) in enumerate(items)]
        _drive(eng)
        assert all(r.done and not r.failed for r in reqs)
        names.append(sorted({(r["name"], r["cat"])
                             for r in tr.snapshot()}))
        assert tr.open_spans == 0
    assert names[0] == names[1]
    assert ("engine.step", "engine") in names[1]
    assert ("ttft.prefill", "ttft") in names[1]


def test_step_fault_writes_flight_record(models, tracing):
    te = _port(models)
    te.runner.get_decode = _dying(te.runner.get_decode, {1})
    reqs = _add(te, _items((5, 7), (6, 6), (0.0, 0.0)))
    _drive(te, faults=True)
    assert all(r.done and not r.failed for r in reqs)
    dumps = glob.glob(str(tracing / "flight-step-fault-RuntimeError-*.jsonl"))
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        head = json.loads(f.readline())
        recs = [json.loads(line) for line in f]
    assert head["reason"] == "step-fault-RuntimeError"
    assert head["records"] == len(recs) > 0
    assert any(r["name"] == "engine.step_fault" for r in recs)
