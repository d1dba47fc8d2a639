"""The port's host KV tier (``kv_host_pages=``, ``inference/kv_tier.py``)
and the prefix cache's tiered entries against paddle_tpu's, on tiny LLaMA
with the same weights (f32) and the reference suite's geometry
(``tests/test_kv_tier.py``: pages of 8, a 24-page pool, two slots, six
48-token templates whose 36 pages overflow the pool).

* The ``PrefixCache`` tier bookkeeping, call for call against the
  reference's class.
* Streams under churn: with the tier on, every request's tokens equal the
  JAX engine's (tier on) and the port's with the tier off — greedy,
  sampled, n-gram spec, chunked prefill and preemption.
* Chaos: ``kv-spill-corrupt`` is caught by the promote digest and costs a
  recompute; ``slow-host-copy`` turns hits into misses without a stall.
* Mechanics: a demote/promote round trip keeps every page byte and the
  page's checksum, host pressure drops instead of wedging, a pool reset
  flushes the tier, the worker stops, the counters reach the scrape.

The tier is asynchronous (a worker thread), so what a run demotes and
promotes depends on timing; the streams must not.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import metric_total, render_prometheus
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

PAGE = 8
VOCAB = 128
TLEN = 48            # 6 full pages per template
NT = 6               # templates: 36 pages against a 23-page pool


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
    kw.setdefault("num_pages", 24)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("chunk_size", 4)
    return kw


def _synthetic_clock(eng):
    """One step time on every engine in place of the wall, so chain
    depths (and the checks and draws that follow them) agree."""
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k, 3.0 + 2 * k)
    return eng


def make_engine(models, hp=64, **kw):
    return _synthetic_clock(Engine(models[1], device="cpu",
                                   prefix_cache=True, kv_host_pages=hp,
                                   **_kw(kw)))


def make_jax(models, hp=64, **kw):
    return _synthetic_clock(JaxEngine(models[0], dtype=jnp.float32,
                                      prefix_cache=True, kv_host_pages=hp,
                                      **_kw(kw)))


def templates(n=NT, tlen=TLEN):
    r = np.random.default_rng(3)
    return [r.integers(0, VOCAB, (tlen,)) for _ in range(n)]


def churn(eng, rounds=2, budget=4, temp=0.0, tail=5):
    """Round-robin template visits with distinct tails (the reference
    suite's workload): the pool holds about two templates, so every round
    demotes and promotes the rest. Every request's tokens, in order."""
    tpls = templates()
    seed = [0]
    reqs = []
    for _ in range(rounds):
        for tpl in tpls:
            seed[0] += 1
            r = np.random.default_rng(1000 + seed[0])
            prompt = np.concatenate([tpl, r.integers(0, VOCAB, (tail,))])
            reqs.append(eng.add_request(
                prompt, budget, temperature=temp,
                seed=77 + seed[0] if temp else None))
            eng.step()
            eng.step()
    eng.run()
    assert all(r.done and not r.failed for r in reqs), \
        [(r.rid, r.failure_reason) for r in reqs if r.failed]
    assert eng._watchdog.last_fault is None
    return [list(r.tokens) for r in reqs]


def shutdown(eng):
    eng._cache.shutdown_tier()


def wait_for(pred, timeout=10.0, drain=None):
    dl = time.monotonic() + timeout
    while time.monotonic() < dl:
        if drain is not None:
            drain()
        if pred():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------- the prefix cache's tiers
def _seeded(cls):
    pc = cls(4)
    toks = np.arange(12, dtype=np.int32)  # 3 chained blocks
    assert pc.register(toks, [5, 6, 7]) == 3
    return pc, toks


def _lk(res):
    """A lookup's result with entries replaced by their keys."""
    if len(res) == 3:
        return res[0], res[1], [e.key for e in res[2]]
    return res


def _scenario_demote(cls):
    pc, toks = _seeded(cls)
    ref = np.zeros(16, np.int32)
    page, ent = pc.take_for_demotion(ref)
    return (page, ent.tier, ent.page, pc.contains_page(7),
            _lk(pc.lookup(toks, tiers=True)), pc.lookup(toks, touch=False),
            pc.hits, pc.misses, pc.evictions)


def _scenario_drain(cls):
    pc, toks = _seeded(cls)
    ref = np.zeros(16, np.int32)
    order = []
    for _ in range(3):
        page, ent = pc.take_for_demotion(ref)
        ent.tier = "host"
        order.append(page)
    return (order, pc.take_for_demotion(ref),
            _lk(pc.lookup(toks, tiers=True)), pc.misses)


def _scenario_promote(cls):
    pc, toks = _seeded(cls)
    _, ent = pc.take_for_demotion(np.zeros(16, np.int32))
    ent.tier, ent.hslot = "host", 2
    job0 = ent.job
    ok = pc.promote(ent, 9)
    again = pc.promote(ent, 9)  # the page is mapped already
    return (ok, again, ent.tier, ent.page, ent.hslot, ent.job - job0,
            pc.lookup(toks, touch=False), ent.stamp == pc._clock)


def _scenario_rebind(cls):
    pc, toks = _seeded(cls)
    _, ent = pc.take_for_demotion(np.zeros(16, np.int32))
    ent.tier, ent.hslot = "host", 1
    released = []
    pc.owner_release = lambda e: released.append(e.key)
    adopted = pc.register(toks, [5, 6, 11])
    return (adopted, ent.tier, ent.page, released == [ent.key],
            pc.lookup(toks, touch=False))


def _scenario_host_evict(cls):
    pc, toks = _seeded(cls)
    ref = np.zeros(16, np.int32)
    _, tail = pc.take_for_demotion(ref)
    tail.tier = "host"
    _, mid = pc.take_for_demotion(ref)
    mid.tier = "host"
    released = []
    pc.owner_release = lambda e: released.append(e.key)
    victim = pc.evict_host_lru()
    second = pc.evict_host_lru()
    return (victim.key == tail.key, second.key == mid.key,
            len(released), pc.lookup(toks, touch=False), pc.evict_host_lru())


def _scenario_invalidate(cls):
    pc, toks = _seeded(cls)
    _, tail = pc.take_for_demotion(np.zeros(16, np.int32))
    tail.tier = "host"
    dropped = pc.invalidate_entry(pc._by_page[5])
    return (sorted(dropped), pc.n_pages, pc.lookup(toks, touch=False)[1],
            pc.invalidate_entry(tail))


def _scenario_clear(cls):
    pc, toks = _seeded(cls)
    _, ent = pc.take_for_demotion(np.zeros(16, np.int32))
    ent.tier, ent.hslot = "host", 3
    released = []
    pc.owner_release = lambda e: released.append(e.key)
    pages = pc.clear()
    return sorted(pages), len(released), ent.key in released


def _scenario_mixed(cls):
    """A longer random walk over every tier transition."""
    rng = np.random.default_rng(5)
    pc = cls(4)
    ref = np.zeros(64, np.int32)
    released = []
    pc.owner_release = lambda e: released.append(e.key)
    out, next_page = [], 1
    prompts = [rng.integers(0, 9, (int(rng.integers(4, 20)),))
               for _ in range(8)]
    for step in range(60):
        op = int(rng.integers(0, 6))
        toks = prompts[int(rng.integers(0, len(prompts)))]
        if op == 0:
            n = len(toks) // 4
            pages = list(range(next_page, next_page + n))
            next_page += n
            out.append(("reg", pc.register(toks, pages)))
        elif op == 1:
            got = pc.take_for_demotion(ref)
            if got is not None:
                got[1].tier = "host"
                got = got[0]
            out.append(("demote", got))
        elif op == 2:
            out.append(("lookup", _lk(pc.lookup(toks, tiers=True))))
        elif op == 3:
            v = pc.evict_host_lru()
            out.append(("hevict", None if v is None else v.key))
        elif op == 4:
            _, _, dem = pc.lookup(toks, touch=False, tiers=True)
            if dem:
                out.append(("promote", pc.promote(dem[0], next_page)))
                next_page += 1
        else:
            out.append(("evict", pc.evict_lru(ref)))
    return out, released, pc.hits, pc.misses, pc.evictions, pc.n_pages


SCENARIOS = {
    "demotion keeps the entry": (_scenario_demote, None),
    "chain drains tail first": (_scenario_drain, None),
    "promote rebinds and restamps": (_scenario_promote, None),
    "register rebinds (recompute as promote)": (_scenario_rebind, None),
    "host eviction is leaf only": (_scenario_host_evict, None),
    "invalidate drops descendants": (_scenario_invalidate, None),
    "clear releases host entries": (_scenario_clear, None),
    "random walk": (_scenario_mixed, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tiered_entries_match_reference(name):
    fn, _ = SCENARIOS[name]
    assert fn(PrefixCache) == fn(JaxPrefixCache)


def test_tiered_entries_expected_values():
    """The reference suite's own expectations, on the port's class."""
    page, tier, epage, has7, tiered, hbm, *_ = _scenario_demote(PrefixCache)
    assert (page, tier, epage, has7) == (7, "spilling", 0, False)
    assert tiered[:2] == ([5, 6], 8) and len(tiered[2]) == 1
    assert hbm == ([5, 6], 8)
    order, none, tiered, _ = _scenario_drain(PrefixCache)
    assert order == [7, 6, 5] and none is None
    assert tiered[1] == 0 and len(tiered[2]) == 3
    ok, again, tier, epage, hslot, dj, lk, fresh = \
        _scenario_promote(PrefixCache)
    assert ok and not again and (tier, epage, hslot, dj) == ("hbm", 9, None,
                                                               1)
    assert lk == ([5, 6, 9], 12) and fresh
    assert _scenario_rebind(PrefixCache) == (0, "hbm", 11, True,
                                             ([5, 6, 11], 12))
    assert _scenario_host_evict(PrefixCache) == (True, True, 2, ([5], 4),
                                                 None)
    assert _scenario_invalidate(PrefixCache) == ([5, 6], 0, 0, [])
    assert _scenario_clear(PrefixCache) == ([5, 6], 3, True)


# ------------------------------------------------------------ mechanics
def test_tier_requires_prefix_cache(models):
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(models[1], device="cpu", kv_host_pages=8, **_kw({}))


def _page_rows(eng, pages):
    idx = torch.as_tensor(pages, dtype=torch.int64)
    return [b.index_select(0, idx).clone() for b in eng._cache.pages_flat()]


def _flood_and_promote(eng, tpl):
    """Serve ``tpl``, flood the pool until its pages are demoted and
    landed on the host, promote them back. (pages before, entries, pages
    after)."""
    eng.add_request(np.concatenate([tpl, np.asarray([1, 2, 3], np.int32)]),
                    2)
    eng.run()
    pc = eng._pcache
    pages0, matched = pc.lookup(tpl, touch=False)
    assert matched == TLEN
    ents = [pc._by_page[p] for p in pages0]
    r = np.random.default_rng(9)
    for _ in range(8):
        eng.add_request(r.integers(0, VOCAB, (40,)), 2)
    eng.run()
    assert eng.kv_tier.demotions >= len(pages0)
    assert wait_for(lambda: all(e.tier == "host" for e in ents),
                    drain=eng._cache.drain_tier), [e.tier for e in ents]
    _, _, demoted = pc.lookup(tpl, touch=False, tiers=True)
    assert demoted
    eng.kv_tier.request_promote(demoted)
    eng.kv_tier.await_promotions(demoted, budget_s=10.0)
    pages1, matched1 = pc.lookup(tpl, touch=False)
    assert matched1 == TLEN
    return pages0, pages1


def test_demote_promote_roundtrip_preserves_bytes(models):
    eng = make_engine(models, hp=64, integrity="audit")
    try:
        tpl = templates()[0]
        before = {}
        orig = eng.kv_tier.demote

        def demote(page, ent):  # the bytes as demotion found them
            before[ent.key] = [r[0] for r in _page_rows(eng, [page])]
            orig(page, ent)

        eng.kv_tier.demote = demote
        eng.add_request(np.concatenate([tpl, [4, 5]]), 2)
        eng.run()
        pc = eng._pcache
        sums0 = [eng._integrity.sum_of_page(p)
                 for p in pc.lookup(tpl, touch=False)[0]]
        pages0, pages1 = _flood_and_promote(eng, tpl)
        for p in pages1:
            key = pc._by_page[p].key
            after = [r[0] for r in _page_rows(eng, [p])]
            for a, b in zip(before[key], after):
                assert torch.equal(a, b)
        # the checksum recorded before the round trip was adopted on the
        # new pages, and the splice probe still passes
        assert [eng._integrity.sum_of_page(p) for p in pages1] == sums0
        assert eng._integrity.verify_pages(pages1) == []
        assert eng.kv_tier.promotions >= len(pages1)
        assert eng.kv_tier.drops == 0
    finally:
        shutdown(eng)


def test_host_capacity_pressure_drops_not_wedges(models):
    eng = make_engine(models, hp=3)  # far below one template
    try:
        toks_on = churn(eng, rounds=2)
        assert eng.kv_tier.drops > 0
        assert toks_on == churn(make_engine(models, hp=0), rounds=2)
    finally:
        shutdown(eng)


def test_pool_reset_flushes_tier(models):
    eng = make_engine(models, hp=64)
    try:
        churn(eng, rounds=1)
        tier = eng.kv_tier
        assert tier.demotions > 0
        eng._recover_step_fault(RuntimeError("injected dispatch death"))
        assert len(tier._free_hslots) == tier.host_pages
        assert not tier._digest and not tier._dev_sum
        assert eng._pcache.n_pages == 0
        eng._watchdog.last_fault = None
        assert churn(eng, rounds=1) == churn(make_engine(models, hp=0),
                                             rounds=1)
    finally:
        shutdown(eng)


def test_shutdown_is_idempotent_and_stops_worker(models):
    eng = make_engine(models, hp=16)
    churn(eng, rounds=1)
    shutdown(eng)
    assert not eng.kv_tier._worker.is_alive()
    shutdown(eng)


def test_scrape_visibility(models):
    eng = make_engine(models, hp=64)
    try:
        churn(eng, rounds=2)
        assert eng.kv_tier.demotions > 0
        text = render_prometheus()
        for name in ("paddle_tpu_kv_tier_demotions_total",
                     "paddle_tpu_kv_tier_promotions_total",
                     "paddle_tpu_kv_tier_hits_total",
                     "paddle_tpu_kv_tier_drops_total",
                     "paddle_tpu_kv_tier_pages",
                     "paddle_tpu_kv_tier_promote_seconds"):
            assert name in text, name
        assert metric_total("paddle_tpu_kv_tier_demotions_total") \
            >= eng.kv_tier.demotions
    finally:
        shutdown(eng)


# ------------------------------------------------------- stream identity
MODES = {
    "greedy": ({}, {}),
    "sampled": ({}, dict(temp=0.8)),
    "spec ngram": (dict(spec="ngram", spec_k=4), {}),
    "chunked prefill": (dict(prefill_chunk=8), {}),
    # budgets whose chain headroom outgrows the pool: preemption while
    # the tier churns
    "preemption": (dict(num_pages=20, max_chain=4),
                   dict(budget=24, tail=3)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tier_streams_match_reference_and_tier_off(models, mode):
    kw, load = MODES[mode]
    eng = make_engine(models, hp=64, **kw)
    jeng = make_jax(models, hp=64, **kw)
    try:
        on = churn(eng, rounds=2, **load)
        assert eng.kv_tier.demotions > 0  # the tier engaged
        assert on == churn(jeng, rounds=2, **load)
        assert on == churn(make_engine(models, hp=0, **kw), rounds=2,
                           **load)
    finally:
        shutdown(eng)
        shutdown(jeng)


# ------------------------------------------------------------------ chaos
def test_kv_spill_corrupt_is_contained(models):
    """A byte flipped in host memory fails the promote digest: the block
    is dropped and recomputed, the failure is counted, and every token
    equals the uninjected run's (the bytes never reach the pool)."""
    fails0 = metric_total("paddle_tpu_integrity_failures_total")
    eng = make_engine(models, hp=64, fault_plan="kv-spill-corrupt:at=1")
    try:
        on = churn(eng, rounds=2)
        assert eng._fi.fired("kv-spill-corrupt") >= 1
        assert eng.kv_tier.drops >= 1
        assert metric_total("paddle_tpu_integrity_failures_total") > fails0
        assert on == churn(make_engine(models, hp=0), rounds=2)
    finally:
        shutdown(eng)


def test_slow_host_copy_degrades_to_miss(models):
    """A glacial worker: hits become partial-prefill misses, with no
    stall and no deadlock, and the streams do not change."""
    eng = make_engine(models, hp=64,
                      fault_plan="slow-host-copy:every=1,delay_ms=150")
    try:
        t0 = time.monotonic()
        on = churn(eng, rounds=2)
        assert eng._fi.fired("slow-host-copy") >= 1
        assert time.monotonic() - t0 < 60.0
        assert on == churn(make_engine(models, hp=0), rounds=2)
    finally:
        shutdown(eng)


def test_worker_fault_is_contained(models):
    """A job that raises in the worker doubts its blocks through the
    completion deque (the reference's ``_post_fault``): they drop, and
    the streams do not change."""
    eng = make_engine(models, hp=64)
    real = eng.kv_tier._promote
    calls = {"n": 0}

    def flaky(job):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("injected host copy failure")
        real(job)

    eng.kv_tier._promote = flaky
    try:
        on = churn(eng, rounds=2)
        assert calls["n"] >= 1 and eng.kv_tier.drops >= 1
        assert on == churn(make_engine(models, hp=0), rounds=2)
    finally:
        shutdown(eng)
