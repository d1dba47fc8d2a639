"""The port's draft-model speculative decoding (``Engine(spec="draft",
draft_model=)``) against paddle_tpu's engine with the same target and
draft weights (f32, ``page_size=8``, ``chunk_size=4``): token streams,
drafts proposed and accepted, verify steps, the drafter's own page pool
and prefix cache, and its fault contract.

The JAX engine runs as its own tests run it on the CPU, with metrics off.
Its drafter's catch-up forward is patched here (``_fixed_catchup``) to
mark each row's width, the form the port's drafter runs: the reference's
unpatched catch-up treats a row whose draft cache is empty as idle and
writes none of its prompt (``test_reference_catchup_skips_empty_rows``
records that; ROADMAP.md queue C). Nothing in the JAX package changes.
Both engines run their default watchdog and one synthetic step time, as
the other parity helpers do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.spec.drafter import \
    DraftModelDrafter as JaxDrafter
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch.convert import gpt_from_numpy, llama_from_numpy
from paddle_tpu_torch.inference import runner as trunner
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.spec import DraftModelDrafter, SpecDecoder
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GEOM = dict(page_size=8, chunk_size=4)
LLAMA = dict(vocab_size=89, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=128, max_position=128)
LLAMA_DRAFT = dict(vocab_size=89, hidden_size=32, num_layers=1,
                   num_heads=2, num_kv_heads=2, intermediate_size=64,
                   max_position=128)
GPT = dict(hidden_size=64, num_layers=2, num_heads=2, max_position=128,
           vocab_size=97)
GPT_DRAFT = dict(hidden_size=32, num_layers=1, num_heads=2,
                 max_position=128, vocab_size=97)


def _fixed_catchup(self):
    """The JAX drafter's catch-up with each row's width marked
    (``prefill_valid``): a row at length 0 prefills its tokens instead of
    idling on the trash page. Otherwise the reference's program."""
    if self._catchup_fn is not None:
        return self._catchup_fn
    from paddle_tpu.framework.tensor import Tensor, pause_tape
    from paddle_tpu.jit import swapped_tensors
    from paddle_tpu.ops.pallas.paged_attention import PagedCacheState

    drafter, dmodel = self, self.model

    @functools.partial(jax.jit, donate_argnums=(1,))
    def draft_catchup(params, pages_flat, tables, lengths, ids, delta):
        n = drafter.cfg.num_layers
        with swapped_tensors(drafter._swap, params), pause_tape():
            states = [PagedCacheState(pages_flat[i], pages_flat[n + i], None,
                                      tables, lengths, drafter.page_size,
                                      prefill_valid=delta, verify=True)
                      for i in range(n)]
            _, new_states = dmodel.forward(Tensor._wrap(ids), caches=states)
            return drafter._pages_of(new_states), lengths + delta

    self._catchup_fn = draft_catchup
    return draft_catchup


@pytest.fixture
def fixed_catchup(monkeypatch):
    monkeypatch.setattr(JaxDrafter, "_get_catchup", _fixed_catchup)


def _pair(jax_cls, jax_cfg, port_cfg, from_numpy, kw, seed):
    paddle.seed(seed)
    jm = jax_cls(jax_cfg(**kw))
    jm.eval()
    tm = from_numpy(port_cfg(**kw), {k: np.asarray(v) for k, v in
                                     param_arrays(jm).items()}, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def llama():
    return (_pair(JaxLlama, JaxLlamaConfig, LlamaConfig, llama_from_numpy,
                  LLAMA, 1),
            _pair(JaxLlama, JaxLlamaConfig, LlamaConfig, llama_from_numpy,
                  LLAMA_DRAFT, 7))


@pytest.fixture(scope="module")
def gpt():
    return (_pair(JaxGPT, JaxGPTConfig, GPTConfig, gpt_from_numpy, GPT, 0),
            _pair(JaxGPT, JaxGPTConfig, GPTConfig, gpt_from_numpy,
                  GPT_DRAFT, 5))


def _synthetic_clock(eng):
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k,
                                                          3.0 + 2.0 * k)
    return eng


def _engines(pair, draft, max_slots=2, num_pages=64, **kw):
    """A JAX and a port engine on the same target, drafting with ``draft``
    (a (jax, port) model pair; None: vanilla)."""
    (jm, tm) = pair
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        jkw.update(spec="draft", draft_model=draft[0])
        tkw.update(spec="draft", draft_model=draft[1])
    je = JaxEngine(jm, max_slots=max_slots, num_pages=num_pages,
                   dtype=jnp.float32, metrics=False, **GEOM, **jkw)
    te = Engine(tm, max_slots=max_slots, num_pages=num_pages, device="cpu",
                **GEOM, **tkw)
    return _synthetic_clock(je), _synthetic_clock(te)


def _serve(eng, items):
    reqs = [eng.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in items]
    eng.run()
    return reqs


def _items(seed, lens, vocab, new=10, temps=None):
    r = np.random.default_rng(seed)
    temps = temps or [0.0] * len(lens)
    return [(r.integers(0, vocab, (n,)), new, t, 30 + i)
            for i, (n, t) in enumerate(zip(lens, temps))]


def _assert_same(je, te, jr, tr):
    assert je._watchdog.last_fault is None and te._watchdog.last_fault is None
    for j, t in zip(jr, tr):
        assert j.failure_reason is None and t.failure_reason is None
        assert t.done and j.done
        assert t.tokens == j.tokens, f"request {t.rid}"
    js, ts = je._spec, te._spec
    assert (ts.drafts_proposed, ts.drafts_accepted, ts.verify_steps) == \
        (js.drafts_proposed, js.drafts_accepted, js.verify_steps)


def _recycled(eng):
    """The drafter's pool is whole again: every page free once, no table
    entry, no refcount."""
    d = eng._spec.drafter
    pool = d._cache
    assert len(set(pool.free_pages)) == len(pool.free_pages)
    assert np.all(d.tables == 0) and np.all(d.lengths == 0)
    if pool.pcache is None:
        assert len(pool.free_pages) == d.num_pages - 1
        assert int(pool.page_ref.sum()) == 0
    else:
        assert (pool.page_ref == 0).all()
        assert set(pool.free_pages).isdisjoint(pool.pcache._by_page)
        assert len(pool.free_pages) + pool.pcache.n_pages == d.num_pages - 1


# ------------------------------------------------------------ parity
def test_llama_draft_matches_jax_and_vanilla(llama, fixed_catchup):
    """The reference's ``test_draft_model_matches_vanilla_engine`` on both
    engines: greedy and sampled requests, a useless draft model. The
    streams and draft counts equal the JAX engine's, the greedy streams
    equal vanilla decode, and the drafter's pool recycles."""
    target, draft = llama
    items = _items(0, [7, 12, 9], 89, temps=[0.0, 0.8, 0.0])
    je, te = _engines(target, draft)
    jr, tr = _serve(je, items), _serve(te, items)
    _assert_same(je, te, jr, tr)
    assert te._spec.drafts_proposed > 0
    _recycled(te)
    assert len(je._spec.drafter._free_pages) == 63
    vanilla = _serve(Engine(target[1], max_slots=2, num_pages=64,
                            device="cpu", **GEOM), items)
    for i in (0, 2):
        assert tr[i].tokens == vanilla[i].tokens


def test_target_as_its_own_draft_accepts_every_draft(llama, fixed_catchup):
    """The target drafting for itself: every greedy draft lands, k+1
    tokens a verify step, as on the JAX engine with the catch-up marked."""
    target, _ = llama
    items = _items(1, [7, 12], 89, new=12)
    je, te = _engines(target, target, spec_k=3)
    jr, tr = _serve(je, items), _serve(te, items)
    _assert_same(je, te, jr, tr)
    st = te._spec
    assert st.drafts_accepted == st.drafts_proposed > 0
    assert te._spec.stats()["accept_rate"] == 1.0
    _recycled(te)


def test_reference_catchup_skips_empty_rows(llama):
    """The divergence, recorded: the reference's own catch-up (unpatched)
    writes no prompt for a new request, so the target as its own draft
    loses most of its drafts there; its greedy streams still equal the
    port's (acceptance keeps only the target's tokens)."""
    target, _ = llama
    items = _items(1, [7, 12], 89, new=12)
    je, te = _engines(target, target, spec_k=3)
    jr, tr = _serve(je, items), _serve(te, items)
    assert [r.tokens for r in jr] == [r.tokens for r in tr]
    assert je._spec.stats()["accept_rate"] < 0.5
    assert te._spec.stats()["accept_rate"] == 1.0


def test_gpt_draft_with_prefix_caches(gpt, fixed_catchup):
    """The reference's ``test_spec_draft_identity_and_drafter_cache`` on
    both engines: a GPT target drafting with a GPT draft, the prefix cache
    on, two identical waves. The second wave hits the drafter's own cache;
    streams, draft counts and drafter hits equal the JAX engine's; greedy
    streams equal the cache-off vanilla run; refcounts stay clean."""
    target, draft = gpt
    items = _items(2, [20, 24, 18], 97)
    je, te = _engines(target, draft, max_slots=3, prefix_cache=True,
                      spec_k=4)
    jr = _serve(je, items) + _serve(je, items)
    tr = _serve(te, items) + _serve(te, items)
    _assert_same(je, te, jr, tr)
    d, jd = te._spec.drafter, je._spec.drafter
    assert d._cache.pcache is not None and d._cache.pcache.hits >= 1
    assert d._cache.pcache.hits == jd._pcache.hits
    _recycled(te)
    clean = _serve(Engine(target[1], max_slots=3, num_pages=64,
                          device="cpu", **GEOM), items)
    assert [r.tokens for r in tr] == [r.tokens for r in clean] * 2


def test_drafter_fault_resyncs_from_history(gpt, fixed_catchup):
    """The reference's ``test_draft_model_drafter_fault_resync`` at three
    requests: every third proposal raises, the drafter resets (its pages
    zeroed in place) and re-syncs every slot; streams and counts equal the
    JAX engine's and the fault-free vanilla run's."""
    target, draft = gpt
    items = _items(3, [20, 9, 22], 97)
    je, te = _engines(target, draft, max_slots=3, spec_k=4,
                      fault_plan="drafter-corruption:every=3")
    pages = [t.data_ptr() for t in te._spec.drafter.k_pages]
    jr, tr = _serve(je, items), _serve(te, items)
    for j, t in zip(jr, tr):
        assert t.done and not t.failed and t.tokens == j.tokens
    js, ts = je._spec, te._spec
    assert ts.drafter_faults == js.drafter_faults >= 1
    assert (ts.drafts_proposed, ts.drafts_accepted) == \
        (js.drafts_proposed, js.drafts_accepted)
    assert [t.data_ptr() for t in te._spec.drafter.k_pages] == pages
    _recycled(te)
    clean = _serve(Engine(target[1], max_slots=3, num_pages=64,
                          device="cpu", **GEOM), items)
    assert [r.tokens for r in tr] == [r.tokens for r in clean]


def test_draft_under_pool_pressure(gpt, fixed_catchup):
    """A pool too small for both requests: the engine preempts and
    re-prefills; the drafter forgets the preempted slot and re-syncs the
    request from its history. Streams and counts equal the JAX
    engine's."""
    target, draft = gpt
    items = _items(4, [16, 16], 97, new=24)
    je, te = _engines(target, draft, num_pages=11, spec_k=3)
    jr, tr = _serve(je, items), _serve(te, items)
    _assert_same(je, te, jr, tr)
    assert te.preemptions >= 1
    _recycled(te)


def test_corrupted_drafts_stay_on_the_device(gpt):
    """``drafter-corruption`` with ``corrupt=1`` shifts every proposed
    token of a draft model's device tensor, on the device: acceptance
    rejects them, nothing fails, and the greedy streams equal vanilla."""
    target, draft = gpt
    items = _items(5, [20, 9], 97)
    te = Engine(target[1], max_slots=2, num_pages=64, device="cpu",
                spec="draft", draft_model=draft[1], spec_k=4,
                fault_plan="drafter-corruption:every=1,corrupt=1", **GEOM)
    seen = []
    propose = te._propose

    def spy(*a):
        out = propose(*a)
        seen.append(out[0])
        return out

    te._propose = spy
    tr = _serve(te, items)
    assert seen and all(isinstance(d, torch.Tensor) for d in seen)
    assert te._spec.drafter_faults == 0 and te._spec.drafts_proposed > 0
    clean = _serve(Engine(target[1], max_slots=2, num_pages=64,
                          device="cpu", **GEOM), items)
    assert [r.tokens for r in tr] == [r.tokens for r in clean]
    assert all(not r.failed for r in tr)
    assert te._dev(seen[0]) is seen[0]


def test_spec_decoder_value_errors(gpt, llama):
    """The reference's refusals: ``spec="draft"`` without a draft model, a
    draft of another vocabulary, an unknown mode; and the port's own: a
    draft in another dtype."""
    target, draft = gpt
    other_vocab = llama[1][1]
    je = JaxEngine(target[0], max_slots=2, num_pages=16, dtype=jnp.float32,
                   metrics=False, **GEOM)
    for jkw, tkw in ((dict(), dict()),
                     (dict(draft_model=llama[1][0]),
                      dict(draft_model=other_vocab))):
        with pytest.raises(ValueError):
            SpecDecoder(je, "draft", **{k: v for k, v in jkw.items()})
        with pytest.raises(ValueError):
            Engine(target[1], max_slots=2, num_pages=16, device="cpu",
                   spec="draft", **GEOM, **tkw)
    with pytest.raises(ValueError):
        Engine(target[1], max_slots=2, num_pages=16, device="cpu",
               spec="medusa", **GEOM)
    half = gpt_from_numpy(GPTConfig(**GPT_DRAFT),
                          {k: v.detach().numpy() for k, v in
                           draft[1].state_dict().items()},
                          device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        Engine(target[1], max_slots=2, num_pages=16, device="cpu",
               spec="draft", draft_model=half, **GEOM)


# ---------------------------------------------------- the captured propose
class StandInGraph:
    """What a CUDA graph does, on the CPU (``tests/test_torch_graph_step.py``
    has the same stand-in): the warm-up and the capture run the body; a
    replay runs it with this thread's launches tallied apart, as a replay
    runs the kernels and no wrapper."""

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


@pytest.fixture
def stand_in(monkeypatch):
    """The drafter's and the engine's steps capture into the CPU stand-in
    graph; the plain twins of #1 and #3 count as the kernels count."""
    monkeypatch.setattr(trunner, "_graph_factory",
                        lambda device: StandInGraph)
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


def test_propose_graph_equals_eager(llama, stand_in):
    """The propose step replayed from a (stand-in) graph gives the eager
    step's drafts and streams; each replay adds the capture's launches (a
    draft layer's #1 per step); the catch-up runs eagerly through #3; a
    reset zeroes the captured pages in place."""
    target, draft = llama
    items = _items(6, [7, 12, 9], 89, new=10, temps=[0.0, 0.7, 0.0])
    runs = {}
    for graphs in (True, False):
        eng = Engine(target[1], max_slots=2, num_pages=64, device="cpu",
                     spec="draft", draft_model=draft[1], spec_k=3, **GEOM)
        d = eng._spec.drafter
        d._graphs.enabled = graphs
        drafts, calls = [], []
        run_propose, catch_up = d._run_propose, d._catch_up

        def spy(slots, nb, k, run_propose=run_propose, drafts=drafts):
            out = run_propose(slots, nb, k)
            drafts.append(out.clone())
            return out

        def spy_catch_up(rows, catch_up=catch_up, calls=calls):
            before = pa.paged_verify_slab_attention.launches
            catch_up(rows)
            calls.append(pa.paged_verify_slab_attention.launches - before)

        d._run_propose, d._catch_up = spy, spy_catch_up
        runs[graphs] = (_serve(eng, items), drafts, calls, d)
    (g_reqs, g_drafts, g_calls, gd), (e_reqs, e_drafts, _, _) = \
        runs[True], runs[False]
    assert [r.tokens for r in g_reqs] == [r.tokens for r in e_reqs]
    assert len(g_drafts) == len(e_drafts) > 0
    for a, b in zip(g_drafts, e_drafts):
        assert torch.equal(a, b)
    steps = [st for st in gd._graphs.steps.values()]
    assert steps and all(st.graph is not None for st in steps)
    for st in steps:
        # one #1 launch a draft layer a step, k steps a replay
        assert dict(((fn.__name__, attr), n) for fn, attr, n in st.deltas) \
            == {("paged_slab_decode_attention", "launches"):
                LLAMA_DRAFT["num_layers"] * 3}
    assert g_calls and all(n == LLAMA_DRAFT["num_layers"] for n in g_calls)
    ptrs = [t.data_ptr() for t in gd.k_pages + gd.v_pages]
    gd.reset()
    assert [t.data_ptr() for t in gd.k_pages + gd.v_pages] == ptrs
    assert all(not t.any() for t in gd.k_pages + gd.v_pages)
    assert len(gd._cache.free_pages) == gd.num_pages - 1


def test_drafter_capacity_follows_the_draft_model(llama):
    """The draft pool's tables stop at the draft model's own
    ``max_position``; its pages hold its KV heads side by side."""
    target, _ = llama
    short = llama_from_numpy(LlamaConfig(**dict(LLAMA_DRAFT,
                                                max_position=32)),
                             {k: v.detach().numpy() for k, v in
                              llama[1][1].state_dict().items()},
                             device="cpu")
    eng = Engine(target[1], max_slots=2, num_pages=16, device="cpu",
                 spec="draft", draft_model=short, **GEOM)
    d = eng._spec.drafter
    assert isinstance(d, DraftModelDrafter)
    assert d.max_pages_per_seq == 32 // GEOM["page_size"]
    assert eng.max_pages_per_seq == 128 // GEOM["page_size"]
    assert tuple(d.k_pages[0].shape) == (16, 8, 2 * 16)
