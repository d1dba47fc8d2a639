"""The port's fault-injection harness (``paddle_tpu_torch/testing``) and
the engine's injection points against paddle_tpu's, on tiny LLaMA with the
same weights (f32, ``page_size=8``, ``chunk_size=4``).

The plan itself is held against the reference plan call for call: the
same spec and seed fire at the same checks and draw the same numbers.
Each engine point is held against the JAX engine under the same spec: the
same requests fail with the same ``failure_reason``, and every other
stream is equal (exact integer equality), to the JAX engine's and to the
fault-free run's. Both engines run on the same synthetic step time, so
their chain depths, and with them the order of the checks, agree. Also:
the flag plumbing (``FLAGS_fault_inject`` / ``PADDLE_TPU_FAULT_INJECT``),
and whole-step recovery from a fault inside a pre-admission wave.
"""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.testing import faultinject as jfi

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.testing import faultinject as tfi
from paddle_tpu_torch.testing.faultinject import (FaultPlan, InjectedFault,
                                                  plan_from_flags)
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(page_size=8, chunk_size=4)
PLENS = (5, 12, 9, 7)
BUDGET = 10


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


# ------------------------------------------------------------ the plan
def test_points_and_grammar_match_reference():
    """Every point the reference knows parses here, in one spec."""
    assert tfi.POINTS == jfi.POINTS
    spec = ";".join(f"{p}:every=2,times=3" for p in jfi.POINTS)
    got = FaultPlan(spec)
    assert all(got.active(p) for p in tfi.POINTS)
    assert jfi.FaultPlan(spec).spec == got.spec
    assert issubclass(InjectedFault, RuntimeError)


SPECS = (
    "nan-logits:rid=2,times=1;slow-step:every=3",
    "step-exception:rate=0.5,seed=7",
    "pool-exhaustion:at=3,times=2;slow-step:every=1,delay_ms=30",
    "step-exception:rate=0.01,seed=7;nan-logits:rate=0.3",
    "drafter-corruption:every=2,corrupt=1",
    "prefix-cache-corruption:at=1;bit-flip-kv:every=2,times=3",
    "replica-crash:rid=1,at=4;kv-handoff-stall:delay_ms=50",
)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_fire_sequences_match_reference(spec, seed):
    """The same spec and seed, the same random sequence of checks: the
    same fire decisions, draws, fire counts and parameters."""
    j, t = jfi.FaultPlan(spec, seed=seed), FaultPlan(spec, seed=seed)
    r = np.random.default_rng(seed + 1)
    for _ in range(300):
        point = jfi.POINTS[int(r.integers(0, len(jfi.POINTS)))]
        rid = None if r.random() < 0.3 else int(r.integers(0, 5))
        assert t.fire(point, rid=rid) == j.fire(point, rid=rid), point
        if r.random() < 0.1:
            n = int(r.integers(1, 1000))
            assert t.draw(point, n) == j.draw(point, n)
    for point in jfi.POINTS:
        assert t.fired(point) == j.fired(point)
        assert t.active(point) == j.active(point)
        assert t.param(point, "delay_ms", 20.0) == \
            j.param(point, "delay_ms", 20.0)


# where each point fires in the port (the training and checkpoint points
# fire since the port has ``hapi`` and ``distributed/checkpoint.py``)
FIRE_SITES = {
    "pool-exhaustion": "inference/engine.py",
    "step-exception": "inference/engine.py",
    "nan-logits": "inference/engine.py",
    "drafter-corruption": "inference/engine.py",
    "slow-step": "inference/engine.py",
    "prefix-cache-corruption": "inference/cache_coord.py",
    "ckpt-io-error": "distributed/checkpoint.py",
    "train-step-exception": "hapi/model.py",
    "train-nan-loss": "hapi/model.py",
    "preempt-signal": "hapi/model.py",
    "slow-ckpt-write": "distributed/checkpoint.py",
    "replica-crash": "serving/router.py",
    "heartbeat-drop": "serving/replica.py",
    "bit-flip-weight": "inference/integrity.py",
    "bit-flip-kv": "inference/cache_coord.py",
    "bit-flip-ckpt": "distributed/checkpoint.py",
    "kv-spill-corrupt": "inference/kv_tier.py",
    "slow-host-copy": "inference/kv_tier.py",
    "racey-worker-write": "inference/kv_tier.py",
    "kv-handoff-corrupt": "serving/cluster.py",
    "kv-handoff-stall": "serving/cluster.py",
}


@pytest.mark.parametrize("point", jfi.POINTS)
def test_every_point_has_a_fire_site(point):
    """No registered point fires nowhere: its module checks it by name."""
    assert set(FIRE_SITES) == set(tfi.POINTS)
    path = os.path.join(ROOT, "paddle_tpu_torch", FIRE_SITES[point])
    with open(path) as f:
        src = f.read()
    assert re.search(r"\.fire\(\s*\"" + re.escape(point) + r"\"", src), \
        (point, path)


def test_spec_parsing_and_semantics():
    plan = FaultPlan("nan-logits:rid=2,times=1;slow-step:every=3")
    assert plan.active("nan-logits") and plan.active("slow-step")
    assert not plan.fire("nan-logits", rid=1)  # rid filter
    assert plan.fire("nan-logits", rid=2)
    assert not plan.fire("nan-logits", rid=2)  # times bound
    fires = [plan.fire("slow-step") for _ in range(6)]
    assert fires == [False, False, True, False, False, True]
    assert plan.param("slow-step", "delay_ms", 20.0) == 20.0
    assert FaultPlan.from_spec(None) is None
    assert FaultPlan.from_spec("  ") is None
    assert FaultPlan.from_spec(plan) is plan


def test_rate_is_deterministic_per_seed():
    a = FaultPlan("step-exception:rate=0.5", seed=7)
    b = FaultPlan("step-exception:rate=0.5", seed=7)
    c = FaultPlan("step-exception:rate=0.5", seed=8)
    fa = [a.fire("step-exception") for _ in range(64)]
    fb = [b.fire("step-exception") for _ in range(64)]
    fc = [c.fire("step-exception") for _ in range(64)]
    assert fa == fb
    assert fa != fc
    assert 10 < sum(fa) < 54  # it is actually probabilistic


def test_unknown_point_rejected():
    with pytest.raises(ValueError, match="unknown fault-injection"):
        FaultPlan("page-fire:every=1")
    with pytest.raises(ValueError, match="malformed"):
        FaultPlan("slow-step:delay_ms")
    with pytest.raises(ValueError, match="unregistered"):
        FaultPlan("slow-step").fire("slow-steps")


def test_flag_plumbing(models):
    prev = flags.get_flags("FLAGS_fault_inject")["FLAGS_fault_inject"]
    try:
        flags.set_flags({"FLAGS_fault_inject": "slow-step:every=2"})
        plan = plan_from_flags()
        assert plan is not None and plan.active("slow-step")
        eng = Engine(models[1], max_slots=2, num_pages=32, device="cpu",
                     **GEOM)  # the engine takes the flag by default
        assert eng._fi is not None and eng._fi.active("slow-step")
        # an explicit plan wins over the flag
        eng = Engine(models[1], max_slots=2, num_pages=32, device="cpu",
                     fault_plan="nan-logits:rid=0", **GEOM)
        assert eng._fi.active("nan-logits")
        assert not eng._fi.active("slow-step")
        flags.set_flags({"FLAGS_fault_inject": ""})
        assert plan_from_flags() is None
        assert Engine(models[1], max_slots=2, num_pages=32, device="cpu",
                      **GEOM)._fi is None
    finally:
        flags.set_flags({"FLAGS_fault_inject": prev})


def test_flag_reads_the_environment():
    """``PADDLE_TPU_FAULT_INJECT`` seeds the flag where it is defined, as
    in the reference; ``FLAGS_fault_inject`` in the environment wins."""
    code = ("from paddle_tpu_torch.framework import flags; "
            "print(flags.get_flags('FLAGS_fault_inject')"
            "['FLAGS_fault_inject'])")
    out = []
    for env in ({"PADDLE_TPU_FAULT_INJECT": "slow-step:every=4"},
                {"PADDLE_TPU_FAULT_INJECT": "slow-step:every=4",
                 "FLAGS_fault_inject": "nan-logits:rid=1"}):
        run = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, check=True,
            capture_output=True, text=True,
            env=dict(os.environ, **env))
        out.append(run.stdout.strip())
    assert out == ["slow-step:every=4", "nan-logits:rid=1"]


# ----------------------------------------------- the engine's points
def _synthetic_clock(eng):
    """The same step time on both engines in place of the wall: the same
    measured boundary cost, so the same depths and checks."""
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k, 3.0 + 2 * k)
    return eng


def _engines(models, plan=None, **kw):
    kw = dict(dict(max_slots=3, num_pages=64), **GEOM, **kw)
    je = JaxEngine(models[0], dtype=jnp.float32, fault_plan=plan, **kw)
    te = Engine(models[1], device="cpu", fault_plan=plan, **kw)
    return _synthetic_clock(je), _synthetic_clock(te)


def _workload(eng, budget=BUDGET, temps=(0.0,)):
    r = np.random.default_rng(0)
    return [eng.add_request(r.integers(0, 128, (n,)), budget,
                            temperature=temps[i % len(temps)], seed=40 + i)
            for i, n in enumerate(PLENS)]


def _run_both(models, plan, temps=(0.0,), **kw):
    """(jax requests, port requests, port engine, clean port streams)."""
    je, te = _engines(models, plan, **kw)
    _, clean = _engines(models, None, **kw)
    out = []
    for eng in (je, te, clean):
        reqs = _workload(eng, temps=temps)
        eng.run()  # never raises
        out.append(reqs)
    return out[0], out[1], te, [list(r.tokens) for r in out[2]]


CASES = {
    # the admission harvest: every request's first check
    "step-exception admission": ("step-exception:rid=1,at=1", {},
                                 {1: "step_fault"}),
    # the second check of request 0: its first decode-chain harvest
    "step-exception chain": ("step-exception:rid=0,at=2", {},
                             {0: "step_fault"}),
    "nan-logits chain": ("nan-logits:rid=2,times=1", {},
                         {2: "nan_logits"}),
    # the mixed step's harvest, mid-prompt
    "nan-logits mixed": ("nan-logits:rid=1,at=2", dict(prefill_chunk=4),
                         {1: "nan_logits"}),
    # the spec verify step's harvest (the first check is the admission's)
    "nan-logits spec": ("nan-logits:rid=1,at=2",
                        dict(spec="ngram", spec_k=4), {1: "nan_logits"}),
    "step-exception spec": ("step-exception:rid=3,at=3",
                            dict(spec="ngram", spec_k=4),
                            {3: "step_fault"}),
    # requests 2 and 3 wait for a slot: their first check is the
    # pre-admission wave's activation
    "step-exception pre-admission": ("step-exception:rid=2,times=1",
                                     dict(max_slots=2), {2: "step_fault"}),
    "nan-logits pre-admission": ("nan-logits:rid=3,times=1",
                                 dict(max_slots=2), {3: "nan_logits"}),
    "pool-exhaustion absorbed": ("pool-exhaustion:at=2,times=2", {}, {}),
    "pool-exhaustion persistent": ("pool-exhaustion:every=1", {},
                                   {i: "pool_exhausted" for i in range(4)}),
    "drafter raises": ("drafter-corruption:every=1",
                       dict(spec="ngram", spec_k=4), {}),
    "drafter corrupt": ("drafter-corruption:every=1,corrupt=1",
                        dict(spec="ngram", spec_k=4), {}),
    "sampled, chunked": ("step-exception:rid=2,at=3;nan-logits:rid=0,at=4",
                         dict(prefill_chunk=4),
                         {2: "step_fault", 0: "nan_logits"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_fault_points_match_reference(models, case):
    plan, kw, failing = CASES[case]
    temps = (0.0, 0.9) if case.startswith("sampled") else (0.0,)
    jr, tr, te, clean = _run_both(models, plan, temps=temps, **kw)
    got = {r.rid: r.failure_reason for r in tr if r.failed}
    assert got == {r.rid: r.failure_reason for r in jr if r.failed}
    assert got == failing
    assert [list(r.tokens) for r in tr] == [list(r.tokens) for r in jr]
    for r in tr:
        if r.rid not in failing:
            assert r.done and list(r.tokens) == clean[r.rid], r.rid
    for name in ("step-exception", "nan-logits", "pool-exhaustion",
                 "drafter-corruption"):
        if te._fi.active(name):
            assert te._fi.fired(name) >= 1
    if failing and "step_fault" in failing.values():
        bad = next(r for r in tr if r.failure_reason == "step_fault")
        assert isinstance(bad.failure.__cause__, InjectedFault)
    assert te._watchdog.last_fault is None  # request-scoped, no recovery
    assert len(te._free_pages) == te.num_pages - 1
    assert np.all(te.tables == 0)


def test_injections_are_counted():
    fam = "paddle_tpu_faults_injected_total"
    before = REGISTRY.get(fam)
    n0 = before.labels(point="slow-step").value if before else 0.0
    plan = FaultPlan("slow-step:every=2")
    fires = sum(plan.fire("slow-step") for _ in range(6))
    assert fires == 3
    assert REGISTRY.get(fam).labels(point="slow-step").value - n0 == 3


def test_slow_step_drives_deadline_expiry(models):
    je, te = _engines(models, "slow-step:every=1,delay_ms=30",
                      deadline_s=0.01)
    for eng in (je, te):
        reqs = _workload(eng)
        eng.run()
        assert [r.failure_reason for r in reqs] == ["deadline"] * 4
    assert te._fi.fired("slow-step") >= 1


def test_deadline_expires_active_request_and_recycles(models):
    """A request that expires mid-decode frees its slot and pages in that
    step; its batchmate keeps going."""
    _, te = _engines(models, "slow-step:every=1,delay_ms=25")
    doomed = te.add_request(np.arange(6), 60, deadline_s=0.03)
    safe = te.add_request(np.arange(1, 7), 6)
    te.run()
    assert doomed.failure_reason == "deadline"
    assert safe.done and not safe.failed and len(safe.tokens) == 6
    assert len(te._free_pages) == te.num_pages - 1
    assert np.all(te.tables == 0)


@pytest.mark.parametrize("point", ["prefix-cache-corruption", "bit-flip-kv"])
def test_prefix_cache_points_match_reference(models, point):
    """A hit doubted (``prefix-cache-corruption``: the page is damaged,
    invalidated with its descendants, and the admission recomputes) or
    silently damaged (``bit-flip-kv``): the same streams, hits and
    misses as the JAX engine; the doubted hit costs a miss and never a
    token."""
    tpl = np.random.default_rng(9).integers(0, 128, (24,))
    out = []
    for plan in (f"{point}:at=1", None):
        je, te = _engines(models, plan, prefix_cache=True)
        res = []
        for eng in (je, te):
            streams = []
            for wave in range(2):
                reqs = [eng.add_request(np.concatenate(
                    [tpl, np.random.default_rng(100 + 10 * wave + i)
                     .integers(0, 128, (5,))]), 6) for i in range(3)]
                eng.run()
                streams.append([list(r.tokens) for r in reqs])
            res.append((streams, eng._pcache.hits, eng._pcache.misses))
        assert res[1] == res[0]
        if plan is not None:
            assert te._fi.fired(point) == 1
        out.append(res[1])
    (faulted, hits, misses), (clean, c_hits, c_misses) = out
    if point == "prefix-cache-corruption":
        assert faulted == clean
        assert (hits, misses) == (c_hits - 1, c_misses + 1)
    else:  # nothing detects a silent flip
        assert (hits, misses) == (c_hits, c_misses)


def test_corrupt_page_writes_in_place(models):
    _, te = _engines(models)
    buf = te._cache.k_pages[0]
    ptr = buf.data_ptr()
    te._cache.corrupt_page(5)
    assert te._cache.k_pages[0] is buf and buf.data_ptr() == ptr
    assert bool((buf[5] == 1e3).all()) and not bool((buf[4] == 1e3).any())


# ---------------------------------- a fault inside the pre-admission wave
def _dying_prefill(get, call):
    """Wrap a ``get_prefill``-style factory so the prefill dispatch of
    ordinal ``call`` (from 1) raises."""
    seen = {"n": 0}

    def factory(*a, **kw):
        fn = get(*a, **kw)

        def prefill(*args, **kwargs):
            seen["n"] += 1
            if seen["n"] == call:
                raise RuntimeError("injected pre-admission fault")
            return fn(*args, **kwargs)

        return prefill

    return factory


def test_preadmission_wave_fault_recovers_like_reference(models):
    """The second prefill of the run is the pre-admission wave (two slots,
    four requests): it raises. Recovery requeues the two active requests
    and the two popped into the wave, each exactly once, in the JAX
    engine's order; the pool reset takes the wave's page rows back; and
    the run ends with the fault-free streams."""
    je, te = _engines(models, max_slots=2)
    je._get_prefill = _dying_prefill(je._get_prefill, 2)
    te.runner.get_prefill = _dying_prefill(te.runner.get_prefill, 2)
    _, clean = _engines(models, max_slots=2)
    want = _workload(clean)
    clean.run()
    after = []
    for eng in (je, te):
        reqs = _workload(eng)
        eng.step()  # admission, chain, the faulted pre-admission wave
        assert isinstance(eng._watchdog.last_fault, RuntimeError)
        assert sorted(r.rid for r in eng._queue) == [0, 1, 2, 3]
        assert all(r.retries == 1 for r in reqs)
        assert not eng._active and not eng._pending_inflight
        assert len(eng._free_pages) == eng.num_pages - 1
        assert sorted(eng._free_slots) == [0, 1]
        after.append([r.rid for r in eng._queue])
        eng.run()
        assert all(r.done and not r.failed for r in reqs)
        assert [list(r.tokens) for r in reqs] == \
            [list(r.tokens) for r in want]
        assert len(eng._free_pages) == eng.num_pages - 1
    assert after[1] == after[0]
    assert not np.any(te._page_ref)


def test_example_runs_disaggregated_with_a_fault_plan():
    """``examples/serve_llama_paged_torch.py --disaggregate --fault-inject``
    on the CPU: the faulted request ends FAILED with its reason, the rest
    finish, and the pool comes back whole."""
    run = subprocess.run(
        [sys.executable, "examples/serve_llama_paged_torch.py", "--tiny",
         "--device", "cpu", "--prefill-chunk", "8", "--disaggregate",
         "--fault-inject", "nan-logits:rid=2,times=1"],
        cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
    out = run.stdout
    assert "request 2: prompt  8 -> FAILED (nan_logits)" in out, out
    assert out.count("tokens (streamed") == 5
    assert "pool fully recycled" in out
