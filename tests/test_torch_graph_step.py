"""The compiled step of the port: the engine's decode token step, its spec
verify step and ``generate``'s decode step written to be captured as CUDA
graphs (``inference/runner.py``), run here on the CPU, where the same
bodies run eagerly.

* Token streams: tiny LLaMA (f32, two layers) through the JAX engine and
  through the port's engine — greedy, sampled, int8 weights, MoE at ep=1
  (with its router stats), n-gram spec — must be identical (exact integer
  equality, no tolerance), and equal to the port's previous eager chain
  and verify step (kept below as ``_previous_*``). ``generate`` on tiny
  GPT and LLaMA equals the JAX ``generate`` and the previous loop.
* ``paddle_serving_compiled_programs_total`` counts the reference's
  lattice (decode per ``(nb, k, sampling)``, verify per ``(nb,
  sampling)``) though one graph serves every depth.
* The replay bookkeeping, through a stand-in for the CUDA graph that only
  these tests inject (``runner._graph_factory``): its capture runs the
  body's Python once (the wrappers count), its replay runs the body with
  the counters held (a replay calls no wrapper). The launch counters must
  grow by the capture's deltas on every replay, an MoE chain must hand
  over a copy of its stats buffer, and a step-fault recovery keeps the
  captured steps (a capture that raised stores none). Every wrapper's
  counter is in the registry the replays add to.
* ``generate`` keeps one step after it returns: a second window drops the
  first's caches before it makes its own; two threads on one model get
  the ids they get one at a time.

The JAX MoE side runs ``grouped_matmul_ref`` (``tests/test_torch_moe.py``
says why). On the CPU no wrapper launches a kernel, so the stand-in tests
count the plain twins' calls of #1 and #3 in their place.
"""
import functools
import sys
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays, state_arrays
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import quant as jquant
from paddle_tpu.observability import REGISTRY as JAX_REGISTRY
from paddle_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul_ref as jax_grouped_ref)

from paddle_tpu_torch.convert import gpt_from_numpy, llama_from_numpy
from paddle_tpu_torch.inference import runner as trunner
from paddle_tpu_torch.inference import sampling
from paddle_tpu_torch.inference.engine import Engine, _moe_tap
from paddle_tpu_torch.inference.spec.acceptance import accept_tokens
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.generation import _pick_fn
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GEOM = dict(page_size=8, chunk_size=4, max_chain=2)
VOCAB = 128


@pytest.fixture(autouse=True)
def jax_grouped_through_ref(monkeypatch):
    mod = sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]
    monkeypatch.setattr(mod, "grouped_matmul", jax_grouped_ref)


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX model, port model) with the same weights: ``dense``, ``int8``
    (weight-only int8, from the JAX model's buffers) or ``moe``."""
    paddle.seed(0)
    if kind == "moe":
        jm = jllama.LlamaForCausalLM(jllama.tiny_moe_llama_config())
        cfg = tllama.tiny_moe_llama_config()
    else:
        jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config())
        cfg = tllama.tiny_llama_config()
    jm.eval()
    if kind == "int8":
        jquant.quantize_for_decode(jm, algo="weight_only_int8")
        arrays = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
        return jm, llama_from_numpy(cfg, arrays, device="cpu",
                                    quant_algo="weight_only_int8")
    arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
    return jm, llama_from_numpy(cfg, arrays, device="cpu")


# ------------------------------------------- the previous eager programs
def _previous_decode_chain(eng, k, sampling):
    """The port's chained decode before its token step was made capturable:
    a Python loop over fresh tensors, the router stats of its steps summed
    and noted once."""
    model, steps, moe_n = eng.model, k * eng.chunk_size, eng._moe_stats_n

    @torch.no_grad()
    def decode_chain(tables, lengths, last_tok, temps, keys):
        bad = torch.zeros(last_tok.shape, dtype=torch.bool)
        toks, last, mstat = [], last_tok, None
        for _ in range(steps):
            states = eng._states_from(tables, lengths)
            with _moe_tap(moe_n) as tap:
                logits, new_states = model(last[:, None], caches=states)
            if tap:
                st = torch.stack(tap).sum(0)
                mstat = st if mstat is None else mstat + st
            last, keys, b = eng._select(logits[:, -1].float(), sampling,
                                        temps, keys)
            bad = bad | b
            lengths = new_states[0].lengths
            toks.append(last)
        eng._note_moe_stats([mstat] if mstat is not None else None)
        return torch.stack(toks, dim=1), lengths, keys, bad

    return decode_chain


def _previous_verify(eng, sampling):
    """The port's spec verify step before it was made capturable."""

    @torch.no_grad()
    def spec_verify_step(tables, lengths, last_tok, drafts, draft_len, temps,
                         keys):
        ids = torch.cat([last_tok[:, None], drafts.long()], dim=1)
        states = eng._states_from(tables, lengths, verify=True)
        with _moe_tap(eng._moe_stats_n) as tap:
            logits, _ = eng.model(ids, caches=states)
        eng._note_moe_stats(tap, verify=True)
        lg = logits.float()
        bad = ~torch.isfinite(lg).all(dim=-1).all(dim=-1)
        toks, n_emit, new_keys = accept_tokens(
            lg, drafts, draft_len, temps, keys, top_k=eng.top_k,
            sampling=sampling)
        cap = tables.shape[1] * eng.page_size
        new_lengths = torch.where(
            lengths > 0,
            torch.clamp(lengths + n_emit.to(lengths.dtype), max=cap),
            lengths)
        return toks, n_emit, new_lengths, new_keys, bad

    return spec_verify_step


def _on_previous_programs(eng):
    eng.runner.get_decode = lambda nb, k, s: _previous_decode_chain(eng, k, s)
    eng.runner.get_verify = lambda s: _previous_verify(eng, s)
    return eng


def _synthetic_clock(eng):
    """Feed ``eng``'s measured boundary cost the same step time ``3 + 2k``
    on both engines in place of the wall: chain depths follow the cost, and
    the schedule (retries, router stats, metrics) with them."""
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k,
                                                          3.0 + 2.0 * k)
    return eng


@torch.no_grad()
def _previous_generate(model, ids, max_new_tokens, temperature=1.0, top_k=0,
                       seed=0, max_seq=None):
    """``generate``'s previous loop: fresh zeroed caches, a Python int time
    step, the key split on the host."""
    b, prompt = ids.shape
    total = max_seq or min(model.config.max_position,
                           prompt + max_new_tokens)
    caches = model.init_caches(b, total, dtype=torch.float32)
    logits, caches = model(ids, caches=caches)
    pick, greedy = _pick_fn(temperature, top_k, ids.dtype)
    key = torch.tensor(sampling.key_from_seed(seed), dtype=torch.int64)
    sub = None
    if not greedy:
        key, sub = sampling.split(key)
    nxt = pick(logits[:, -1], sub)
    out = [ids, nxt[:, None]]
    rkey = key
    for i in range(min(max_new_tokens - 1, total - 1 - prompt)):
        logits, caches = model(nxt[:, None], caches=caches,
                               time_step=prompt + i)
        if not greedy:
            rkey, sub = sampling.split(rkey)
        nxt = pick(logits[:, -1], sub)
        out.append(nxt[:, None])
    return torch.cat(out, dim=1)


# ---------------------------------------------------- the CUDA stand-in
class StandInGraph:
    """What a CUDA graph does, on the CPU: the warm-up runs the body; the
    capture runs the body's Python once (the wrappers count into the
    capturing thread's tally); a replay runs the body with this thread's
    launches tallied apart, as a replay runs the kernels and no
    wrapper."""

    made = []
    fail_next_capture = False

    def __init__(self, owner):
        self.body = None
        self.replays = 0
        StandInGraph.made.append(self)

    def warm_up(self, body):
        body()

    def capture(self, body):
        if StandInGraph.fail_next_capture:
            StandInGraph.fail_next_capture = False
            raise RuntimeError("injected capture fault")
        body()
        self.body = body

    def replay(self):
        with build.tally_launches():
            self.body()
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """Engines (and ``generate``) capture into ``StandInGraph``; the plain
    twins of #1 and #3 count their calls as the kernels count launches."""
    StandInGraph.made = []
    StandInGraph.fail_next_capture = False
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
    return StandInGraph


def _counts():
    return (pa.paged_slab_decode_attention.launches,
            pa.paged_verify_slab_attention.launches)


# -------------------------------------------------------------- serving
ENGINE_CASES = {
    "greedy": ("dense", dict(max_slots=3),
               [(6, 11, 0.0), (13, 9, 0.0), (4, 14, 0.0)]),
    "sampled": ("dense", dict(max_slots=3),
                [(7, 12, 0.8), (5, 10, 0.0), (11, 9, 1.2)]),
    "int8": ("int8", dict(max_slots=2),
             [(5, 12, 0.0), (12, 10, 0.8), (9, 8, 0.0)]),
    "moe": ("moe", dict(max_slots=2),
            [(9, 10, 0.0), (14, 8, 0.7), (6, 12, 0.0)]),
    "spec": ("dense", dict(max_slots=2, spec="ngram", spec_k=4),
             [(18, 12, 0.0), (10, 12, 0.9)]),
}


def _items(case, seed=0):
    _, _, spec = ENGINE_CASES[case]
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, m, t) in enumerate(spec):
        if case == "spec":  # a repeated span, so the drafter finds matches
            p = np.tile(rng.integers(0, VOCAB, (6,)), 4)[:n]
        else:
            p = rng.integers(0, VOCAB, (n,))
        out.append((p, m, t, 21 + i))
    return out


def _serve(eng, items):
    reqs = [eng.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in items]
    eng.run()
    # a recovered step fault can leave the streams equal all the same
    assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.tokens) for r in reqs]


def _port(case, eager=False, **extra):
    """The port's engine for ``case``; ``eager`` turns its graphs off (the
    stand-in tests' baseline)."""
    kind, kw, _ = ENGINE_CASES[case]
    eng = _synthetic_clock(Engine(_pair(kind)[1], num_pages=64,
                                  device="cpu", **GEOM, **kw, **extra))
    eng.runner._graphs.enabled = not eager
    return eng


def _moe_fields(eng):
    st = eng.moe_stats()
    return (st["tokens_routed"], st["pairs_kept"], st["pairs_dropped"],
            st["expert_load"])


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_step_bodies_match_reference_and_previous(case):
    """The capturable bodies, run eagerly, serve the JAX engine's streams
    and the port's previous eager programs' streams, token for token; an
    MoE engine's router stats equal both."""
    kind, kw, _ = ENGINE_CASES[case]
    items = _items(case)
    je = _synthetic_clock(JaxEngine(_pair(kind)[0], num_pages=64,
                                    dtype=jnp.float32, metrics=False,
                                    **GEOM, **kw))
    want = _serve(je, items)
    port = _port(case)
    assert _serve(port, items) == want
    prev = _on_previous_programs(_port(case))
    assert _serve(prev, items) == want
    assert not port.runner._graphs.steps or all(
        s.graph is None for s in port.runner._graphs.steps.values())
    if kind == "moe":
        js = je.moe_stats()
        assert _moe_fields(port) == _moe_fields(prev) == (
            js["tokens_routed"], js["pairs_kept"], js["pairs_dropped"],
            js["expert_load"])
        assert port.moe_stats()["router_entropy"] == \
            prev.moe_stats()["router_entropy"]


def _compiled(reg):
    m = reg.get("paddle_serving_compiled_programs_total")
    return {} if m is None else {k: leaf.value for k, leaf in m.series()}


def test_compiled_programs_lattice_matches_reference():
    """The same workloads (two batch buckets, greedy and sampled chains of
    several depths; a spec engine's verify steps) count the same programs
    by kind on both engines, though the port captures one decode graph per
    ``(nb, sampling)`` and no depth."""
    counts = []
    for make, reg in ((lambda **kw: _synthetic_clock(JaxEngine(
            _pair("dense")[0], num_pages=64, dtype=jnp.float32, **GEOM,
            **kw)), JAX_REGISTRY),
            (lambda **kw: _synthetic_clock(Engine(
                _pair("dense")[1], num_pages=64, device="cpu", **GEOM,
                **kw)), REGISTRY)):
        before = _compiled(reg)
        vanilla = make(max_slots=4)
        _serve(vanilla, _items("sampled") + _items("greedy", seed=1)[:1])
        spec = make(max_slots=2, spec="ngram", spec_k=4)
        _serve(spec, _items("spec"))
        after = _compiled(reg)
        counts.append({k: v - before.get(k, 0) for k, v in after.items()
                       if v - before.get(k, 0)})
    assert counts[0] == counts[1]
    assert counts[1][("decode",)] >= 2 and counts[1][("verify",)] >= 1
    # the port's vanilla engine (the last made): two depths, one step
    assert len(vanilla.runner.decode_fns) > len(vanilla.runner._graphs.steps)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_replays_count_launches_and_keep_streams(case, stand_in):
    """Through the stand-in graph: the streams are the eager engine's;
    each decode step's capture records one #1 launch a layer (a verify
    step's one #3 launch a layer); the counters end where the eager run's
    end plus one warm-up run of every captured step."""
    layers = _pair(ENGINE_CASES[case][0])[1].config.num_layers
    items = _items(case)
    c0 = _counts()
    want = _serve(_port(case, eager=True), items)
    eager = [a - b for a, b in zip(_counts(), c0)]
    assert not stand_in.made
    graphed = _port(case)
    c0 = _counts()
    assert _serve(graphed, items) == want
    got = [a - b for a, b in zip(_counts(), c0)]
    steps = list(graphed.runner._graphs.steps.items())
    assert steps and all(s.graph is not None for _, s in steps)
    warm = [0, 0]
    for (key, _), s in steps:
        which = 0 if key[0] == "decode" else 1
        counter = (pa.paged_slab_decode_attention if which == 0
                   else pa.paged_verify_slab_attention)
        assert s.deltas == ((counter, "launches", layers),)
        assert s.graph.replays > 0
        warm[which] += layers
    assert got == [e + w for e, w in zip(eager, warm)]
    if case == "moe":
        assert _moe_fields(graphed) == _moe_fields(_eager_moe(items))


def _eager_moe(items, **extra):
    eng = _port("moe", eager=True, **extra)
    _serve(eng, items)
    return eng


def test_replay_adds_deltas_per_replay(stand_in):
    """``CapturedStep.run(n)`` adds n times each delta, and the capture
    itself leaves the counters as they were."""
    eng = _port("greedy")
    chain = eng.runner.get_decode(2, 1, False)
    c0 = pa.paged_slab_decode_attention.launches
    with torch.no_grad():
        step = eng.runner._graphs.get(("decode", 2, False),
                                      lambda: eng._decode_step(2, False))
    layers = eng.cfg.num_layers
    # the warm-up is a real run of the body; the capture counts nothing
    assert pa.paged_slab_decode_attention.launches == c0 + layers
    for n in (1, 3, 5):
        before = pa.paged_slab_decode_attention.launches
        step.bufs.idx.zero_()
        with torch.no_grad():
            step.run(n)
        assert pa.paged_slab_decode_attention.launches == \
            before + n * layers
        assert step.graph.replays >= n
    before = pa.paged_slab_decode_attention.launches
    chain(*(torch.zeros(s, dtype=d) for s, d in (
        ((2, eng.max_pages_per_seq), torch.int32), ((2,), torch.int32),
        ((2,), torch.int64), ((2,), torch.float32), ((2, 2), torch.int64))))
    assert pa.paged_slab_decode_attention.launches == \
        before + eng.chunk_size * layers


def test_moe_stats_handed_over_as_a_copy_per_chain(stand_in):
    """Each chain notes a copy of the step's stats buffer: with several
    chains behind one fetch (``multi_step=4``) each is noted while the
    earlier ones are pending, in a tensor of its own, and the totals equal
    the eager engine's on the same schedule (the JAX engine's at
    ``multi_step=1``: ``test_engine_step_bodies_match_reference_and_
    previous``)."""
    items = _items("moe")
    chains = []
    eng = _port("moe", multi_step=4)
    real = eng._note_moe_stats

    def note(tap, verify=False):
        # a chain notes one summed vector; a prefill one a layer (two)
        if tap and len(tap) == 1:
            chains.append(([v for v, _ in eng._moe_pending], tap[0]))
        real(tap, verify)

    eng._note_moe_stats = note
    want = _serve(_port("moe", eager=True, multi_step=4), items)
    assert _serve(eng, items) == want
    buffers = [s.bufs.mstat.data_ptr()
               for (key, _), s in eng.runner._graphs.steps.items()
               if key[0] == "decode"]
    assert buffers and len(chains) >= 3
    assert all(t.data_ptr() not in buffers for _, t in chains)
    stacked = [(pend, t) for pend, t in chains if pend]
    assert stacked
    for pend, t in stacked:
        assert all(v.data_ptr() != t.data_ptr() for v in pend)
    assert _moe_fields(eng) == _moe_fields(_eager_moe(items, multi_step=4))


def _dying(get, calls_to_fail):
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


def test_recovery_keeps_captured_steps(stand_in):
    """A decode dispatch that raises after its bucket was captured: the
    step recovers (every request requeues and recomputes), the captured
    steps stay the same objects and nothing is captured again; the
    streams are the fault-free ones."""
    items = _items("sampled")
    want = _serve(_port("sampled", eager=True), items)
    eng = _port("sampled")
    eng.runner.get_decode = _dying(eng.runner.get_decode, {2})
    reqs = [eng.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in items]
    eng.step()  # admission and the first chain: its bucket captured
    assert eng._watchdog.last_fault is None and eng.runner._graphs.steps
    held = dict(eng.runner._graphs.steps)
    made = len(stand_in.made)
    for _ in range(200):
        if not eng.step():
            break
    assert isinstance(eng._watchdog.last_fault, RuntimeError)
    assert [list(r.tokens) for r in reqs] == want
    for key, step in held.items():
        assert eng.runner._graphs.steps[key] is step
    new_keys = set(eng.runner._graphs.steps) - set(held)
    assert len(stand_in.made) == made + len(new_keys)


def test_failed_capture_stores_no_step(stand_in):
    """A capture that raises faults the step (recovered, not hidden); the
    bucket holds no step and captures again at its next use; the streams
    are the fault-free ones."""
    items = _items("greedy")
    want = _serve(_port("greedy", eager=True), items)
    eng = _port("greedy")
    stand_in.fail_next_capture = True
    reqs = [eng.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in items]
    eng.step()
    assert isinstance(eng._watchdog.last_fault, RuntimeError)
    assert "injected capture fault" in str(eng._watchdog.last_fault)
    assert not eng.runner._graphs.steps
    for _ in range(200):
        if not eng.step():
            break
    assert [list(r.tokens) for r in reqs] == want
    assert all(s.graph is not None
               for s in eng.runner._graphs.steps.values())


def test_graphs_off_keeps_steps_eager(stand_in):
    """``_graphs.enabled = False`` (the eager side of ``chip_smoke.py``'s
    comparison) keeps every step eager: nothing is captured."""
    eng = _port("greedy", eager=True)
    want = _serve(_port("greedy"), _items("greedy"))
    assert stand_in.made
    stand_in.made = []
    assert _serve(eng, _items("greedy")) == want
    assert not stand_in.made
    assert all(s.graph is None for s in eng.runner._graphs.steps.values())


def test_ordered_writes_carry_the_last_writer():
    """``ordered_writes``: each write carries the row of the last write
    (row-major) to its (page, slot), so colliding writes land the bytes a
    one-by-one write leaves; a write alone on its slot keeps its own row."""
    ps, h_kv, d = 4, 1, 8
    pages = [torch.zeros((3, ps, h_kv * d)) for _ in range(2)]
    state = pa.PagedCacheState(pages[0], pages[1], None,
                               torch.zeros((2, 2), dtype=torch.int32),
                               torch.zeros((2,), dtype=torch.int32), ps,
                               ordered_writes=True)
    phys = torch.tensor([[0, 2], [0, 0], [1, 0]])
    slot = torch.tensor([[1, 3], [1, 2], [0, 1]])
    assert pa._last_writers(state, phys, slot).tolist() == [5, 1, 5, 3, 4, 5]
    k = torch.arange(6 * d, dtype=torch.float32).reshape(3, 2, h_kv, d)
    pa._write(state, phys, slot, k, -k)
    want = torch.zeros_like(pages[0])
    for i in range(3):
        for j in range(2):
            want[phys[i, j], slot[i, j]] = k[i, j].reshape(-1)
    assert torch.equal(pages[0], want) and torch.equal(pages[1], -want)
    assert state.replace(lengths=state.lengths).ordered_writes


def test_moe_engine_orders_writes_and_warm_up_keeps_the_trash_page(stand_in):
    """An MoE engine's states order their writes (a dense one's do not);
    a step's warm-up and capture leave the trash page as they found it."""
    dense, moe = _port("greedy"), _port("moe")
    tables = torch.zeros((2, dense.max_pages_per_seq), dtype=torch.int32)
    lens = torch.zeros((2,), dtype=torch.int32)
    assert not any(st.ordered_writes for st in dense._states_from(tables,
                                                                  lens))
    assert all(st.ordered_writes for st in moe._states_from(tables, lens))
    for t in moe._cache.k_pages + moe._cache.v_pages:
        t[0].fill_(7.0)
    with torch.no_grad():
        step = moe.runner._graphs.get(("decode", 2, False),
                                      lambda: moe._decode_step(2, False),
                                      keep=moe._cache.trash_kept)
    # the stand-in's warm-up and capture both ran the body on idle rows,
    # whose writes land on the trash page
    assert step.graph is not None and len(stand_in.made) == 1
    assert all(bool((t[0] == 7.0).all())
               for t in moe._cache.k_pages + moe._cache.v_pages)


# ----------------------------------------------------------- generate
GPT_TINY = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
                max_position=64)


@functools.lru_cache(maxsize=None)
def _gen_pair(family):
    paddle.seed(0)
    if family == "gpt":
        jm = JaxGPT(JaxGPTConfig(**GPT_TINY))
        arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
        tm = gpt_from_numpy(GPTConfig(**GPT_TINY), arrays, device="cpu")
    else:
        jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config())
        arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
        tm = llama_from_numpy(tllama.tiny_llama_config(), arrays,
                              device="cpu")
    jm.eval()
    tm.eval()
    return jm, tm


PICKS = {"greedy": dict(temperature=0.0),
         "top_k": dict(temperature=0.8, top_k=5, seed=3),
         "sampled": dict(temperature=1.0, seed=7)}


@pytest.mark.parametrize("mode", sorted(PICKS))
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_step_matches_reference_and_previous(family, mode):
    """The capturable decode step, run eagerly, gives the JAX
    ``generate``'s ids and the previous loop's; a second call reuses the
    step (its caches zeroed) and gives them again."""
    jm, tm = _gen_pair(family)
    ids = np.random.default_rng(3).integers(0, tm.config.vocab_size,
                                            (2, 6)).astype(np.int32)
    kw = dict(max_new_tokens=10, **PICKS[mode])
    want = np.asarray(jm.generate(Tensor._wrap(jnp.asarray(ids)), **kw)._data)
    prev = _previous_generate(tm, torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(prev.numpy(), want)
    for _ in range(2):
        got = tm.generate(torch.from_numpy(ids), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    steps = tm._decode_graphs().steps
    assert len([k for k in steps if k[0][0] == 2]) >= 1


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_through_stand_in_graph(family, stand_in):
    """Captured before the prefill, replayed once a token: the stand-in's
    capture and warm-up write into the step's caches, which the call
    zeroes before its prefill, so the ids equal the JAX ``generate``'s."""
    jm, _ = _gen_pair(family)
    _, tm = _gen_pair.__wrapped__(family)
    ids = np.random.default_rng(4).integers(0, tm.config.vocab_size,
                                            (2, 5)).astype(np.int32)
    for mode in ("greedy", "sampled"):
        kw = dict(max_new_tokens=9, **PICKS[mode])
        want = np.asarray(jm.generate(Tensor._wrap(jnp.asarray(ids)),
                                      **kw)._data)
        got = tm.generate(torch.from_numpy(ids), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(stand_in.made) == 2
    assert [g.replays for g in stand_in.made] == [8, 8]


def test_generate_recaptures_when_weights_change():
    """``quantize_for_decode`` swaps the weights: the next ``generate``
    builds its steps anew (the old ones held pointers to the old
    weights), and its ids equal the previous loop's on the new weights."""
    _, tm = _gen_pair.__wrapped__("gpt")
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 96, (2, 5)))
    tm.generate(ids, max_new_tokens=6, temperature=0.0)
    before = tm._decode_graphs()
    tquant.quantize_for_decode(tm, algo="weight_only_int8")
    got = tm.generate(ids, max_new_tokens=6, temperature=0.0)
    assert tm._decode_graphs() is not before
    want = _previous_generate(tm, ids, 6, temperature=0.0)
    assert torch.equal(got, want)


def test_every_launch_counter_is_registered():
    """Each wrapper's launch counters (its attributes ending in
    ``launches``) are in ``build.LAUNCH_COUNTERS``, the registry a replay
    adds its deltas to, and nothing else is."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    found = {(fn, attr) for mod in (pa, da, fa, gm, qm)
             for fn in vars(mod).values() if callable(fn)
             for attr in getattr(fn, "__dict__", ())
             if attr.endswith("launches")}
    assert len(found) == 16
    assert set(build.LAUNCH_COUNTERS) == found
    assert len(build.LAUNCH_COUNTERS) == len(found)


def test_graph_set_drops_the_old_step_before_making_the_new():
    """At its limit a ``GraphSet`` drops the least recently used step
    before the new step's buffers are made: the two are never held at
    once."""
    graphs = trunner.GraphSet(torch.device("cpu"), limit=1)
    first = graphs.get("a", lambda: (lambda: None, torch.zeros(4)))
    gone = weakref.ref(first.bufs)
    del first
    seen = []

    def make():
        seen.append(gone())
        return (lambda: None), torch.zeros(8)

    graphs.get("b", make)
    assert seen == [None] and list(graphs.steps) == [("b", True)]


def test_generate_keeps_one_step_and_drops_the_last_window():
    """A second window's ``generate`` leaves one step on the model, its
    own: the first window's caches are freed, and both calls give the
    previous loop's ids."""
    _, tm = _gen_pair.__wrapped__("gpt")
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 96, (2, 5)))
    firsts = []
    for window in (32, 48):
        got = tm.generate(ids, max_new_tokens=6, temperature=0.0,
                          max_seq=window)
        want = _previous_generate(tm, ids, 6, temperature=0.0,
                                  max_seq=window)
        assert torch.equal(got, want)
        steps = list(tm._decode_graphs().steps.values())
        assert len(steps) == 1
        assert steps[0].bufs.caches[0].shape[2] == window
        firsts.append(weakref.ref(steps[0].bufs.caches[0]))
        del steps
    assert firsts[0]() is None and firsts[1]() is not None


def test_generate_from_two_threads_on_one_model():
    """Two threads calling ``generate`` on one model at once (the same key,
    then two keys) get the ids each gets alone: the calls, which share
    the step's buffers, run one at a time."""
    _, tm = _gen_pair.__wrapped__("llama")
    rng = np.random.default_rng(7)
    ids = [torch.from_numpy(rng.integers(0, tm.config.vocab_size, (2, 5)))
           for _ in range(2)]
    for kws in ([PICKS["sampled"]] * 2, [PICKS["greedy"], PICKS["top_k"]]):
        want = [tm.generate(i, max_new_tokens=8, **kw)
                for i, kw in zip(ids, kws)]
        got = [None, None]
        start = threading.Barrier(2)

        def call(n, kw):
            start.wait()
            got[n] = tm.generate(ids[n], max_new_tokens=8, **kw)

        threads = [threading.Thread(target=call, args=(n, kw))
                   for n, kw in enumerate(kws)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kws
