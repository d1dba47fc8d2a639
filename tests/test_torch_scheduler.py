"""The rest of the engine's scheduler in the port against paddle_tpu's
``Engine`` on tiny LLaMA (and tiny MoE LLaMA) with the same weights, f32,
``page_size=8``, ``chunk_size=4``: pre-admission, the measured
chain-boundary cost with its depth probes, and ``disaggregate=True``.

Token streams must be exactly equal. Chain depths depend on the measured
boundary cost and so on wall time; router stats, step counts and the
schedule depend on the depths. So every parity test that compares a
schedule replaces the wall on BOTH engines by the same synthetic step time
``T(nb, k) = R + k * C`` (``_synthetic_clock``): the measured ratio, the
probes and every depth are then the same on both sides. The JAX MoE side
runs its grouped expert matmul through ``grouped_matmul_ref``, as
``test_torch_moe.py`` patches it in.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul_ref as jax_grouped_ref)

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models import llama as tllama
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GEOM = dict(page_size=8, chunk_size=4)
R, C = 3.0, 2.0  # the synthetic step time T(nb, k) = R + k * C


@pytest.fixture(autouse=True)
def jax_grouped_through_ref(monkeypatch):
    mod = sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]
    monkeypatch.setattr(mod, "grouped_matmul", jax_grouped_ref)


def _pair(jcfg, tcfg):
    jm = jllama.LlamaForCausalLM(jcfg)
    jm.eval()
    tm = llama_from_numpy(tcfg, {k: np.asarray(v)
                                 for k, v in param_arrays(jm).items()},
                          device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    return _pair(jllama.tiny_llama_config(), tllama.tiny_llama_config())


@pytest.fixture(scope="module")
def moe_models():
    paddle.seed(0)
    return _pair(jllama.tiny_moe_llama_config(),
                 tllama.tiny_moe_llama_config())


def _synthetic_clock(eng):
    """Feed ``eng``'s boundary-cost fit ``R + k * C`` in place of the wall
    (either package's engine)."""
    observe = eng._observe_chain_time

    def synthetic(nb, k, wall):
        return observe(nb, k, R + k * C)

    eng._observe_chain_time = synthetic
    return eng


def _engines(models, **kw):
    """The JAX engine and the port's, same geometry, synthetic clocks."""
    kw = dict(GEOM, **kw)
    je = JaxEngine(models[0], dtype=jnp.float32, **kw)
    te = Engine(models[1], device="cpu", **kw)
    return _synthetic_clock(je), _synthetic_clock(te)


def _prompts(n_req, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(6, 20)),))
            for _ in range(n_req)]


def _trace(eng, reqs_in, limit=400):
    """Queue ``reqs_in`` [(prompt, budget, temperature, seed)] and step
    ``eng`` to the end, recording ``(len(_active), len(_queue))`` after
    every step. Returns (requests, schedule)."""
    reqs = [eng.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in reqs_in]
    sched = []
    for _ in range(limit):
        live = eng.step()
        sched.append((len(eng._active), len(eng._queue)))
        if not live:
            break
    else:
        raise AssertionError("engine did not drain")
    assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
    return reqs, sched


def _tokens(reqs):
    return [list(r.tokens) for r in reqs]


def _count_preadmits(eng):
    """Count the requests ``eng``'s pre-admission waves take."""
    seen = []
    wave = eng._preadmit_dispatch

    def counted(k, exclude=()):
        out = wave(k, exclude)
        seen.extend(r.rid for r, *_ in out[0])
        return out

    eng._preadmit_dispatch = counted
    return seen


# ---------------------------------------- the MoE-stats fault, closed
MOE_KEYS = ("tokens_routed", "pairs_kept", "pairs_dropped", "expert_load")


@pytest.mark.parametrize("budgets", [(12, 12, 12), (5, 20, 9), (16, 3, 24)],
                         ids=["12-12-12", "5-20-9", "16-3-24"])
def test_moe_multi_step_schedule_and_stats_match(moe_models, budgets):
    """Three requests on two slots at ``multi_step=4``: the queued request
    is pre-admitted in the shadow of the chain that frees its slot, so
    both engines keep the same ``(active, queued)`` after every step and
    route the same tokens (the port without pre-admission ended its first
    step with 1 active and 1 queued, and routed fewer overshoot tokens)."""
    je, te = _engines(moe_models, max_slots=2, num_pages=64, max_chain=2,
                      multi_step=4)
    vocab = moe_models[1].config.vocab_size
    items = [(p, m, 0.0, None)
             for p, m in zip(_prompts(3, 3, vocab), budgets)]
    pre = _count_preadmits(te)
    jr, js = _trace(je, items)
    tr, ts = _trace(te, items)
    assert _tokens(tr) == _tokens(jr)
    assert ts == js
    assert pre, "pre-admission never engaged"
    if budgets == (5, 20, 9):
        assert ts[0] == (2, 0)  # the queued request is active after step 1
    jst, tst = je.moe_stats(), te.moe_stats()
    for key in MOE_KEYS:
        assert tst[key] == jst[key], key


# ------------------------------------------------------- pre-admission
@pytest.mark.parametrize("multi", [1, 4], ids=["ms1", "ms4"])
def test_preadmission_schedule_matches_reference(models, multi):
    """Five greedy and sampled requests on two slots, no eos: queue heads
    pre-admit in the shadow of the chains that free their slots, with the
    JAX engine's schedule step for step and its streams."""
    je, te = _engines(models, max_slots=2, num_pages=96, max_chain=2,
                      multi_step=multi)
    vocab = models[1].config.vocab_size
    items = [(p, m, t, s) for p, m, t, s in zip(
        _prompts(5, 11, vocab), (12, 7, 15, 9, 12),
        (0.0, 0.8, 0.0, 1.1, 0.0), (None, 5, None, 9, None))]
    pre = _count_preadmits(te)
    jr, js = _trace(je, items)
    tr, ts = _trace(te, items)
    assert _tokens(tr) == _tokens(jr)
    assert ts == js
    assert len(pre) >= 2
    assert all(r.done and not r.failed for r in tr)
    assert len(te._free_pages) == te.num_pages - 1
    assert np.all(te.tables == 0)


@pytest.mark.slow
def test_turnover_prefills_in_chain_shadow(models):
    """Twice as many queued greedy requests as slots, no eos: the queue
    heads pre-admit during the chain that frees their slots, and the
    streams equal the JAX engine's."""
    je, te = _engines(models, max_slots=2, num_pages=96, max_chain=2)
    rng = np.random.default_rng(1)
    items = [(rng.integers(0, 128, (n,)), 12, 0.0, None)
             for n in (5, 9, 7, 11, 6)]
    pre = _count_preadmits(te)
    jr, _ = _trace(je, items)
    tr, _ = _trace(te, items)
    assert pre
    assert all(r.done and len(r.tokens) == 12 for r in tr)
    assert _tokens(tr) == _tokens(jr)


def test_eos_disables_preadmission(models):
    """An eos makes completions unpredictable: the gate returns nothing
    even with queued requests and predicted-complete actives, and the
    engine still serves as the reference does."""
    je, te = _engines(models, max_slots=2, num_pages=96, max_chain=2,
                      eos_id=127)
    rng = np.random.default_rng(2)
    first = [(rng.integers(0, 127, (n,)), 4, 0.0, None) for n in (5, 5, 6)]
    later = [(rng.integers(0, 127, (n,)), 10, 0.0, None) for n in (5, 9, 7)]
    out = []
    for eng in (je, te):
        for p, m, t, s in first:
            eng.add_request(p, m, temperature=t, seed=s)
        eng._admit()
        assert eng._queue and eng._active  # the gate's real precondition
        assert eng._preadmit_dispatch(2) == ([], None, None, None)
        reqs, _ = _trace(eng, later)
        assert all(r.done for r in reqs)
        out.append(_tokens(reqs))
    assert out[1] == out[0]


def test_pool_pressure_skips_preadmission(models):
    """A pool too tight for a standalone prefill row falls back to the
    normal admission after the turnover rather than failing."""
    je, te = _engines(models, max_slots=2, num_pages=20, max_chain=1)
    rng = np.random.default_rng(3)
    items = [(rng.integers(0, 128, (n,)), 8, 0.0, None)
             for n in (5, 9, 7, 6)]
    jr, js = _trace(je, items)
    tr, ts = _trace(te, items)
    assert all(r.done and len(r.tokens) == 8 for r in tr)
    assert _tokens(tr) == _tokens(jr)
    assert ts == js


@pytest.mark.slow
def test_sampled_preadmission_deterministic(models):
    """A sampled request pre-admitted mid-serve gives the tokens it gives
    when served alone with the same seed."""
    def serve(batchmates):
        _, te = _engines(models, max_slots=2, num_pages=96, max_chain=2)
        rng = np.random.default_rng(4)
        items = [(rng.integers(0, 128, (6,)), 10, 0.0, None)
                 for _ in range(batchmates)]
        items.append((np.arange(5), 10, 0.8, 1234))
        reqs, _ = _trace(te, items)
        return reqs[-1].tokens

    assert serve(0) == serve(4)


def test_preadmission_gates_and_fifo(models):
    """The reference's gates on the port alone: chunked mode never
    pre-admits, an ``exclude``d queue head stops the wave (FIFO), and
    nothing is predicted to finish past the chain's horizon."""
    _, tm = models
    eng = Engine(tm, max_slots=2, num_pages=96, device="cpu", **GEOM)
    for n in (5, 6, 7, 8):
        eng.add_request(np.arange(n), 4)
    eng._admit()
    head = eng._queue[0]
    assert eng._preadmit_dispatch(1, exclude=[head]) == \
        ([], None, None, None)
    # a horizon of one chunk covers the 4-token budgets: both heads go
    pending, tok, _, _ = eng._preadmit_dispatch(1)
    assert [r.rid for r, *_ in pending] == [2, 3] and tok is not None
    assert not eng._queue
    chunked = Engine(tm, max_slots=2, num_pages=96, device="cpu",
                     prefill_chunk=4, **GEOM)
    for n in (5, 6, 7):
        chunked.add_request(np.arange(n), 4)
    chunked._bind_chunked()
    assert chunked._preadmit_dispatch(4) == ([], None, None, None)
    far = Engine(tm, max_slots=2, num_pages=96, device="cpu", **GEOM)
    for n in (5, 6, 7):
        far.add_request(np.arange(n), 40)
    far._admit()
    assert far._preadmit_dispatch(2) == ([], None, None, None)


# ------------------------------------------ the measured boundary cost
SAMPLES = [(2, 2, 0.90), (2, 2, 1.10), (2, 2, 1.00),  # one depth: probe
           (4, 2, 1.50),                               # a new bucket: probe
           (4, 2, 1.60), (2, 1, 0.70),                 # two depths: a fit
           (2, 1, 0.72), (2, 2, 1.02), (4, 1, 1.20),
           (2, 2, 0.74), (2, 1, 0.73),                 # a flatter slope
           (4, 1, 2.00),                               # a negative slope
           (8, 2, 100.0), (8, 4, 102.5)]               # a ratio past 64


def test_observe_chain_time_and_probes_match_reference(models):
    """The same fixed ``(nb, k, wall)`` samples into both engines' fits:
    the same ``_dispatch_ratio`` after every sample, and the same
    ``_chain_depth()`` at each point, the two probes included."""
    je = JaxEngine(models[0], max_slots=2, num_pages=96, max_chain=4,
                   dtype=jnp.float32, **GEOM)
    te = Engine(models[1], max_slots=2, num_pages=96, max_chain=4,
                device="cpu", **GEOM)
    for eng in (je, te):
        for n in (5, 9):
            eng.add_request(np.arange(n), 40)
        eng._admit()
    assert te.DISPATCH_COST_CHUNKS_PRIOR == je.DISPATCH_COST_CHUNKS_PRIOR
    depths = {"jax": [], "port": []}
    for nb, k, wall in SAMPLES:
        for tag, eng in (("jax", je), ("port", te)):
            eng._observe_chain_time(nb, k, wall)
            depths[tag].append(eng._chain_depth())
        assert te._dispatch_ratio == je._dispatch_ratio
        assert te._chain_obs == je._chain_obs
        assert te._probe_budget == je._probe_budget
        assert te._boundary_cost_chunks() == je._boundary_cost_chunks()
    assert depths["port"] == depths["jax"]
    assert te._probe_budget == 0  # both probes ran
    assert depths["port"][2:4] == [2, 2]  # the two probes (the best is 4)
    assert te._dispatch_ratio is not None


def test_cost_pin_fixes_the_depth_and_stops_probes(models):
    """The private pin ``chip_smoke.py`` sets on a graph run and its eager
    twin: the depth uses the pinned cost and no probe runs."""
    _, tm = models
    eng = Engine(tm, max_slots=2, num_pages=96, max_chain=4, device="cpu",
                 **GEOM)
    for n in (5, 9):
        eng.add_request(np.arange(n), 40)
    eng._admit()
    eng._cost_pin = eng.DISPATCH_COST_CHUNKS_PRIOR
    for _ in range(4):
        eng._observe_chain_time(2, 4, 1.0)
    assert [eng._chain_depth() for _ in range(3)] == [4, 4, 4]
    assert eng._probe_budget == 2
    eng._cost_pin = None
    assert eng._chain_depth() == 2  # unpinned: the first probe


@pytest.mark.parametrize("multi", [1, 4], ids=["ms1", "ms4"])
def test_synthetic_clock_schedule_matches_reference(models, multi):
    """A long pure-decode workload on a synthetic clock: both engines take
    their samples at the same steps, probe at the same steps, fit the
    same ratio ``R / C`` and choose the same depth sequence."""
    je, te = _engines(models, max_slots=4, num_pages=128, max_chain=2,
                      multi_step=multi)
    depths = {}
    for tag, eng in (("jax", je), ("port", te)):
        seen = depths[tag] = []
        choose = eng._chain_depth

        def recorded(choose=choose, seen=seen):
            k = choose()
            seen.append(k)
            return k

        eng._chain_depth = recorded
    vocab = models[1].config.vocab_size
    items = [(p, 60, 0.0, None) for p in _prompts(4, 6, vocab)]
    jr, js = _trace(je, items)
    tr, ts = _trace(te, items)
    assert _tokens(tr) == _tokens(jr)
    assert ts == js
    assert depths["port"] == depths["jax"]
    assert te._dispatch_ratio == je._dispatch_ratio
    assert te._probe_budget == je._probe_budget
    assert te._chain_time_ema == je._chain_time_ema
    if multi == 1:  # two probes at depth 1 gave the fit its second depth
        assert te._dispatch_ratio == pytest.approx(R / C)
        assert te._probe_budget == 0
        assert depths["port"].count(1) >= 2
    else:  # the multi-step path takes no sample
        assert te._dispatch_ratio is None and te._chain_obs == 0


# ------------------------------------------------- disaggregate=True
def _serve(eng, vocab, n_req=4, budget=8, temps=(0.0,), seed=3):
    """After the reference's ``tests/test_tp_serving.py`` ``serve``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        p = rng.integers(0, vocab, (int(rng.integers(6, 20)),))
        reqs.append(eng.add_request(p, budget,
                                    temperature=temps[i % len(temps)]))
    eng.run()
    return reqs


@pytest.mark.parametrize("temps", [(0.0,), (0.0, 0.7)],
                         ids=["greedy", "sampled"])
def test_disaggregated_streams_match(models, temps):
    """``disaggregate=True`` (prefill-role chunks beside decode-role
    chains in one step) against the plain unchunked engine, the plain
    chunked engine and the JAX disaggregated engine."""
    vocab = models[1].config.vocab_size
    geo = dict(max_slots=2, num_pages=64, max_chain=2)
    dis = dict(geo, prefill_chunk=4, disaggregate=True)
    je, te = _engines(models, **dis)
    both = []
    step = te._disagg_step

    def counted():
        """One disaggregated step, noting whether it dispatched both the
        mixed step and a chain."""
        seen = set()
        mixed, chain = te._mixed_dispatch, te._chain_dispatch

        def mixed_d(*a):
            seen.add("mixed")
            return mixed(*a)

        def chain_d(*a):
            seen.add("chain")
            return chain(*a)

        te._mixed_dispatch, te._chain_dispatch = mixed_d, chain_d
        try:
            step()
        finally:
            del te._mixed_dispatch, te._chain_dispatch
        both.append(seen == {"mixed", "chain"})

    te._disagg_step = counted
    got = _tokens(_serve(te, vocab, temps=temps))
    want = _tokens(_serve(je, vocab, temps=temps))
    _, plain = _engines(models, **geo)
    _, chunked = _engines(models, **geo, prefill_chunk=4)
    assert got == want
    assert got == _tokens(_serve(plain, vocab, temps=temps))
    assert got == _tokens(_serve(chunked, vocab, temps=temps))
    assert any(both), "no step ran both roles"
    assert te._watchdog.last_fault is None
    assert len(te._free_pages) == te.num_pages - 1


def test_disaggregated_chaos_matches_reference(models):
    """A nan-logits injection inside the disaggregated step fails ONE
    request, as in the JAX engine, while its batchmates stream as in the
    fault-free run."""
    vocab = models[1].config.vocab_size
    kw = dict(max_slots=2, num_pages=64, max_chain=2, prefill_chunk=4,
              disaggregate=True)
    plan = "nan-logits:rid=2,times=1"
    je, te = _engines(models, fault_plan=plan, **kw)
    jr, tr = _serve(je, vocab), _serve(te, vocab)
    _, clean = _engines(models, **kw)
    base = _tokens(_serve(clean, vocab))
    assert _tokens(tr) == _tokens(jr)
    assert [r.failure_reason for r in tr] == \
        [r.failure_reason for r in jr] == [None, None, "nan_logits", None]
    assert _tokens(tr) != base          # rid 2's stream was cut short
    assert _tokens(tr)[:2] == base[:2]  # its batchmates are untouched
    assert _tokens(tr)[3] == base[3]
    assert te._fi.fired("nan-logits") == 1


def test_disaggregate_requires_prefill_chunk(models):
    _, tm = models
    with pytest.raises(ValueError, match="disaggregate"):
        Engine(tm, max_slots=2, num_pages=64, device="cpu",
               disaggregate=True, **GEOM)
