"""The port's serving modes that ride the verify kernel, against paddle_tpu's
``Engine`` on tiny LLaMA with the same weights (f32, ``page_size=8``,
``chunk_size=4``): the prefix cache, chunked prefill and n-gram speculative
decoding, alone and combined. The same requests must give token-identical
streams in both engines, and the cache must score the same hits.

The JAX engine runs as its own tests run it on the CPU (its multi-query
attention takes ``_paged_multi_query_ref``), with metrics off. Both engines
run their default watchdog: for spec decoding its acceptance-collapse
switch is live on both sides and must turn spec off at the same step.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models.llama import tiny_llama_config

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


def _engines(models, max_slots=3, num_pages=64, **kw):
    jm, tm = models
    je = JaxEngine(jm, max_slots=max_slots, num_pages=num_pages,
                   dtype=jnp.float32, metrics=False, **GEOM, **kw)
    te = Engine(tm, max_slots=max_slots, num_pages=num_pages, device="cpu",
                **GEOM, **kw)
    return je, te


def _serve(eng, waves):
    """Serve ``waves`` one after another, each run to completion: a wave is
    [(prompt, max_new, temperature, seed)]. Returns the requests."""
    out = []
    for wave in waves:
        reqs = [eng.add_request(p, m, temperature=t, seed=s)
                for p, m, t, s in wave]
        eng.run()
        out += reqs
    return out


def _serve_both(models, waves, **kw):
    je, te = _engines(models, **kw)
    jr, tr = _serve(je, waves), _serve(te, waves)
    # a recovered step fault can leave the streams equal all the same
    assert je._watchdog.last_fault is None and te._watchdog.last_fault is None
    for j, t in zip(jr, tr):
        assert j.failure_reason is None and t.failure_reason is None, \
            (j.failure_reason, t.failure_reason)
        assert t.done and j.done
        assert t.tokens == j.tokens, f"request {t.rid}"
    return je, te, jr, tr


def _conserved(eng):
    """Every page is free, cached or table-referenced exactly refcount
    times; nothing leaked."""
    free = eng._free_pages
    assert len(set(free)) == len(free)
    refs = np.zeros_like(eng._page_ref)
    for row in eng.tables:
        for p in row:
            if p:
                refs[int(p)] += 1
    assert np.array_equal(refs, eng._page_ref)
    cached = set(eng._pcache._by_page) if eng._pcache is not None else set()
    active = {int(p) for row in eng.tables for p in row if p}
    assert set(free).isdisjoint(cached | active)
    assert set(free) | cached | active == set(range(1, eng.num_pages))


def _rng_prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, VOCAB, (n,)).astype(np.int64) for n in lens]


PREAMBLE = _rng_prompts(7, [24])[0]


def _shared(tails_seed, tail_lens):
    return [np.concatenate([PREAMBLE, t])
            for t in _rng_prompts(tails_seed, tail_lens)]


# ------------------------------------------------------------ prefix cache
@pytest.mark.parametrize("sampled", [False, True])
def test_prefix_cache_streams_match(models, sampled):
    """A first wave publishes a shared 24-token preamble; the second wave's
    requests splice it and prefill only their tails (the suffix program),
    one of them repeating a first-wave prompt exactly (a full match: the
    copy-on-write of its last page)."""
    t = 0.8 if sampled else 0.0
    first = _shared(1, [5, 8])
    second = _shared(2, [3, 11]) + [first[1]]
    waves = [[(p, 9, t, 10 + i) for i, p in enumerate(first)],
             [(p, 9, t, 20 + i) for i, p in enumerate(second)]]
    je, te, _, tr = _serve_both(models, waves, prefix_cache=True)
    assert te._pcache.hits == je._pcache.hits >= 3
    assert te._pcache.misses == je._pcache.misses
    # the full match reports prefix.size - 1 cached tokens
    assert te._cache.cached_tokens >= 2 * 24 + first[1].size - 1
    _conserved(te)


def test_prefix_cache_mixed_hit_miss_wave(models):
    """One admission wave holding a hit row and a miss row runs the suffix
    program for both (base 0 on the miss row)."""
    waves = [[(p, 8, 0.0, None) for p in _shared(3, [6])],
             [(p, 8, 0.0, None) for p in
              _shared(4, [9]) + _rng_prompts(5, [30])]]
    je, te, _, _ = _serve_both(models, waves, prefix_cache=True)
    assert te._pcache.hits == je._pcache.hits == 1
    assert te._pcache.misses == je._pcache.misses == 2


def test_prefix_cache_evicts_before_preempting(models):
    """A pool where the second wave fits only by reclaiming the first
    wave's idle cached pages: LRU eviction takes all the pressure, no
    request is preempted, and the streams still match."""
    waves = [[(p, 8, 0.0, None) for p in _rng_prompts(8, [24, 24, 24])],
             [(p, 8, 0.0, None) for p in _rng_prompts(9, [24, 24, 24])]]
    je, te, _, _ = _serve_both(models, waves, num_pages=20,
                               prefix_cache=True)
    assert te._pcache.evictions == je._pcache.evictions > 0
    assert te._pcache.hits == je._pcache.hits
    assert te.preemptions == 0
    _conserved(te)


# --------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_sampled_streams_match(models, chunk):
    """Prompts of several chunks stream in while other slots decode; a
    sampled mix burns one key per delivered token (the emit gate)."""
    prompts = _rng_prompts(10, [5, 19, 9, 30])
    waves = [[(p, 10, t, 30 + i) for i, (p, t) in
              enumerate(zip(prompts, [0.0, 0.9, 0.0, 0.7]))]]
    _serve_both(models, waves, prefill_chunk=chunk)


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_with_prefix_cache(models, chunk):
    waves = [[(p, 8, 0.0, None) for p in _shared(11, [7])],
             [(p, 8, 0.5, 40 + i) for i, p in
              enumerate(_shared(12, [13, 2]))]]
    je, te, _, _ = _serve_both(models, waves, prefill_chunk=chunk,
                               prefix_cache=True)
    assert te._pcache.hits == je._pcache.hits == 2
    _conserved(te)


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_preempted_mid_prefill(models, chunk):
    """A pool too small for every prompt preempts while prompts are
    mid-stream; the recompute policy re-chunks from scratch."""
    prompts = _rng_prompts(13, [20, 24, 18])
    waves = [[(p, 12, t, 50 + i) for i, (p, t) in
              enumerate(zip(prompts, [0.0, 0.8, 0.0]))]]
    je, te, _, _ = _serve_both(models, waves, num_pages=9,
                               prefill_chunk=chunk)
    assert te.preemptions >= 1
    assert not te._chunk_left
    _conserved(te)


# ------------------------------------------------------------ spec decode
def _repetitive(seed, lens, span=6):
    """Prompts that repeat a short span, so the n-gram drafter finds
    matches."""
    r = np.random.default_rng(seed)
    out = []
    for n in lens:
        unit = r.integers(0, VOCAB, (span,))
        out.append(np.tile(unit, -(-n // span))[:n].astype(np.int64))
    return out


def test_spec_greedy_and_sampled_streams_match(models):
    prompts = _repetitive(14, [18, 25, 12])
    waves = [[(p, 14, t, 60 + i) for i, (p, t) in
              enumerate(zip(prompts, [0.0, 0.9, 0.0]))]]
    je, te, _, _ = _serve_both(models, waves, spec="ngram", spec_k=3)
    st = te._spec.stats()
    assert st["verify_steps"] > 0 and st["accept_rate"] > 0
    assert te._spec.drafts_accepted == je._spec.drafts_accepted
    assert te._spec.verify_steps == je._spec.verify_steps


def test_spec_eos_mid_block(models):
    """An eos inside an accepted block truncates the stream there and
    frees the slot, rows past the eos included."""
    prompts = _repetitive(15, [18, 20])
    waves = [[(p, 16, 0.0, None) for p in prompts]]
    _, te, _, tr = _serve_both(models, waves, spec="ngram", spec_k=4)
    eos = tr[0].tokens[5]
    je, te, _, tr = _serve_both(models, waves, spec="ngram", spec_k=4,
                                eos_id=eos)
    assert tr[0].tokens[-1] == eos and len(tr[0].tokens) <= 6
    assert len(te._free_pages) == te.num_pages - 1


def test_spec_under_pool_pressure(models):
    prompts = _repetitive(16, [20, 22, 17])
    waves = [[(p, 14, t, 70 + i) for i, (p, t) in
              enumerate(zip(prompts, [0.0, 0.8, 0.0]))]]
    je, te, _, _ = _serve_both(models, waves, num_pages=9, spec="ngram",
                               spec_k=4)
    assert te.preemptions >= 1
    _conserved(te)


def test_spec_with_prefix_cache(models):
    waves = [[(p, 10, 0.0, None) for p in _shared(17, [4])],
             [(p, 10, t, 80 + i) for i, (p, t) in
              enumerate(zip(_shared(18, [6, 10]), [0.0, 0.7]))]]
    je, te, _, _ = _serve_both(models, waves, spec="ngram", spec_k=3,
                               prefix_cache=True)
    assert te._pcache.hits == je._pcache.hits == 2


def test_spec_with_chunked_prefill(models):
    prompts = _repetitive(19, [26, 9])
    waves = [[(p, 12, 0.0, None) for p in prompts]]
    _serve_both(models, waves, spec="ngram", spec_k=3, prefill_chunk=8)


def test_int8_pages_through_every_mode(models):
    """``quantized_cache=True`` with all three modes on: int8 pages and
    their bf16 scales go through the suffix prefill, the mixed step and the
    verify step; quantisation is bit-identical, so the streams are too."""
    waves = [[(p, 10, 0.0, None) for p in _shared(20, [8])],
             [(p, 10, t, 90 + i) for i, (p, t) in
              enumerate(zip(_shared(21, [5, 17]) + _repetitive(22, [30]),
                            [0.0, 0.6, 0.0]))]]
    je, te, _, _ = _serve_both(models, waves, quantized_cache=True,
                               prefix_cache=True, prefill_chunk=8,
                               spec="ngram", spec_k=3)
    assert te._pcache.hits == je._pcache.hits == 2
    _conserved(te)
