"""The port's serving ``Engine`` against paddle_tpu's on tiny LLaMA with the
same weights: the same mixed-length requests (f32, ``max_slots=2``,
``page_size=8``) must give token-identical streams — all greedy, a sampled
mix with temperatures and seeds, a pool small enough to force recompute
preemption, and an eos. Plus the port's up-front validation, streaming,
the resume path, ``TypeError`` for every unported engine knob, and the
construction rules of ``kv_host_pages=`` and ``integrity=`` against the
reference's (their behaviour is in ``test_torch_kv_tier.py`` and
``test_torch_integrity.py``; the
modes that ride the verify kernel are in ``test_torch_serving_modes.py``;
pre-admission, the measured boundary cost, ``disaggregate=`` and
``fault_plan=`` in ``test_torch_scheduler.py`` and
``test_torch_faultinject.py``)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.errors import (AdmissionRejected,
                                               ValidationError)
from paddle_tpu_torch.models.llama import tiny_llama_config
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GEOM = dict(max_slots=2, page_size=8, chunk_size=4)


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


def _prompts(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (n,)) for n, *_ in spec]


def _synthetic_clock(eng):
    """Feed ``eng``'s measured boundary cost the same step time ``3 + 2k``
    on both engines in place of the wall: chain depths follow the cost, and
    the schedule (retries, router stats, metrics) with them."""
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k,
                                                          3.0 + 2.0 * k)
    return eng


def _serve_both(models, spec, num_pages=64, **kw):
    """spec: [(prompt_len, max_new, temperature, seed)]."""
    jm, tm = models
    prompts = _prompts(spec)
    je = _synthetic_clock(JaxEngine(jm, num_pages=num_pages,
                                    dtype=jnp.float32, metrics=False,
                                    **GEOM, **kw))
    te = _synthetic_clock(Engine(tm, num_pages=num_pages, device="cpu",
                                 **GEOM, **kw))
    out = []
    for eng in (je, te):
        reqs = [eng.add_request(p, m, temperature=t, seed=s)
                for p, (n, m, t, s) in zip(prompts, spec)]
        eng.run()
        # a recovered step fault can leave the streams equal all the same
        assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
        out.append(reqs)
    return je, te, out[0], out[1]


def _assert_same(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert t.failure_reason is None and j.failure_reason is None
        assert t.done and j.done
        assert t.tokens == j.tokens, f"request {t.rid}"


def test_greedy_streams_match(models):
    spec = [(5, 12, 0.0, None), (12, 10, 0.0, None), (9, 14, 0.0, None),
            (20, 9, 0.0, None), (3, 16, 0.0, None)]
    _, te, jr, tr = _serve_both(models, spec)
    _assert_same(jr, tr)
    assert all(len(t.tokens) == m for t, (_, m, _, _) in zip(tr, spec))
    # every page went back to the pool
    assert len(te._free_pages) == te.num_pages - 1
    assert np.all(te.tables == 0) and np.all(te.lengths == 0)


def test_sampled_mix_matches(models):
    spec = [(5, 12, 0.0, None), (12, 10, 0.8, 3), (9, 14, 0.0, None),
            (20, 9, 1.0, 7), (3, 16, 0.5, None), (7, 11, 1.3, 99)]
    _, _, jr, tr = _serve_both(models, spec, top_k=20)
    _assert_same(jr, tr)


def test_int8_page_streams_match(models):
    """quantized_cache=True: int8 pages with bf16 scale pages; the
    quantization is bit-identical, so the streams are too."""
    spec = [(5, 12, 0.0, None), (12, 10, 0.8, 3), (9, 14, 0.0, None)]
    _, te, jr, tr = _serve_both(models, spec, quantized_cache=True)
    _assert_same(jr, tr)
    assert te._cache.k_pages[0].dtype == torch.int8
    assert te._cache.scale_pages[0].dtype == torch.bfloat16


def test_preempted_streams_match(models):
    """Seven usable pages cannot hold two of these requests at once: the
    longest is evicted, requeued and re-prefilled (prompt plus generated
    tokens, live key carried), in both engines, with identical output."""
    spec = [(5, 30, 0.0, None), (12, 25, 0.8, 3), (9, 20, 0.0, None),
            (20, 9, 1.0, 7), (3, 30, 0.5, 11)]
    _, te, jr, tr = _serve_both(models, spec, num_pages=8)
    _assert_same(jr, tr)
    assert te.preemptions >= 1
    assert any(t.retries for t in tr) and any(j.retries for j in jr)
    assert [t.retries for t in tr] == [j.retries for j in jr]


def test_eos_streams_match(models):
    spec = [(5, 20, 0.0, None), (9, 20, 0.0, None), (4, 20, 0.7, 5)]
    # an eos id that the greedy stream of request 0 actually emits
    _, _, _, tr = _serve_both(models, spec)
    eos = tr[0].tokens[3]
    _, _, jr, tr = _serve_both(models, spec, eos_id=eos)
    _assert_same(jr, tr)
    assert tr[0].tokens[-1] == eos and len(tr[0].tokens) <= 4


def test_on_token_streams_every_token(models):
    _, tm = models
    eng = Engine(tm, num_pages=32, device="cpu", **GEOM)
    seen = []
    req = eng.add_request(np.arange(6), 9, on_token=seen.extend)
    eng.run()
    assert seen == req.tokens and len(seen) == 9


def test_raising_callback_fails_only_its_request(models):
    _, tm = models
    eng = Engine(tm, num_pages=32, device="cpu", **GEOM)

    def boom(_):
        raise RuntimeError("caller bug")

    bad = eng.add_request(np.arange(5), 8, on_token=boom)
    good = eng.add_request(np.arange(7), 8)
    eng.run()
    assert bad.state == "FAILED" and bad.failure_reason == "callback"
    assert good.state == "FINISHED" and len(good.tokens) == 8


def test_sampled_resume_continues_the_stream(models):
    """A stream resumed from its first 5 emitted tokens (and its seed)
    continues exactly as the uninterrupted one."""
    _, tm = models
    p = np.arange(10) % 128
    full = Engine(tm, num_pages=32, device="cpu", **GEOM)
    r0 = full.add_request(p, 15, temperature=0.9, seed=4)
    full.run()
    res = Engine(tm, num_pages=32, device="cpu", **GEOM)
    r1 = res.add_request(p, 15, temperature=0.9, seed=4,
                         resume_tokens=r0.tokens[:5])
    res.run()
    assert r1.tokens == r0.tokens


@pytest.mark.parametrize("knob", [
    dict(tp=2, prefix_cache=True, kv_host_pages=8), dict(ep=2,
                                                         integrity="audit"),
    dict(tp=2, ep=2, spec="draft"), dict(tp=2, quant="weight_only_int8")])
def test_unported_knobs_raise_type_error(models, knob):
    """The one knob a tp/ep > 1 engine refuses, weight-only quantized
    layers, raises ``TypeError`` naming why, before any rank is needed
    (the reference cannot serve them sharded). The host KV tier, the
    integrity sentinel and draft-model spec decoding are served sharded:
    without a process world they reach the reference's rank check
    (``ValueError``), as a plain tp/ep > 1 engine does."""
    _, tm = models
    knob = dict(knob)
    model = tm
    if "quant" in knob:
        from paddle_tpu_torch.nn.quant import quantize_for_decode

        model = copy.deepcopy(tm)
        quantize_for_decode(model, algo=knob.pop("quant"))
        with pytest.raises(TypeError, match="weight-only quantized.*"
                                            "RetriesExhausted"):
            Engine(model, num_pages=32, device="cpu", **GEOM, **knob)
        return
    if knob.get("spec") == "draft":
        knob["draft_model"] = tm
    with pytest.raises(ValueError, match="ranks"):
        Engine(model, num_pages=32, device="cpu", **GEOM, **knob)


def test_tp1_is_the_single_device_engine(models):
    """``tp=1`` (and ``ep=1``) builds the single-device engine, as the
    reference's; tp > 1 with no process world raises the reference's
    ``ValueError``, and a quantized cache at tp > 1 its
    ``NotImplementedError``, before any rank is needed."""
    _, tm = models
    eng = Engine(tm, num_pages=32, device="cpu", tp=1, ep=1, **GEOM)
    assert not eng.runner.sharded and eng.is_leader
    assert eng._batch_quantum == 1
    assert eng.runner.param_specs is None
    eng.close()  # a no-op without followers
    with pytest.raises(ValueError, match="needs 2 ranks"):
        Engine(tm, num_pages=32, device="cpu", tp=2, **GEOM)
    with pytest.raises(NotImplementedError, match="quantized"):
        Engine(tm, num_pages=32, device="cpu", tp=2, quantized_cache=True,
               **GEOM)


def test_draft_knobs_are_ported(models):
    """``spec="draft"`` is ported: without a draft model it raises the
    reference's ``ValueError``; a draft model without ``spec="draft"`` is
    ignored, as in the reference."""
    _, tm = models
    with pytest.raises(ValueError, match="draft_model"):
        Engine(tm, num_pages=32, device="cpu", spec="draft", **GEOM)
    eng = Engine(tm, num_pages=32, device="cpu", draft_model=tm, **GEOM)
    assert eng._spec is None
    eng = Engine(tm, num_pages=32, device="cpu", spec="draft",
                 draft_model=tm, **GEOM)
    assert eng._spec.drafter.name == "draft"


@pytest.mark.parametrize("knob", [
    dict(prefix_cache=True, kv_host_pages=8), dict(integrity="audit"),
    dict(integrity="strict"), dict(integrity={"shadow_every": 2}),
    dict(prefix_cache=True, kv_host_pages=8, integrity="audit")])
def test_tier_and_integrity_knobs_construct(models, knob):
    """The two knobs build what the reference builds: a host tier of the
    asked size with its worker, a sentinel of the asked mode."""
    jm, tm = models
    je = JaxEngine(jm, num_pages=32, dtype=jnp.float32, **GEOM, **knob)
    te = Engine(tm, num_pages=32, device="cpu", **GEOM, **knob)
    try:
        assert (te.kv_tier is None) == (je.kv_tier is None)
        if te.kv_tier is not None:
            assert te.kv_tier.host_pages == je.kv_tier.host_pages == 8
            assert te.kv_tier._worker.is_alive()
        assert (te._integrity is None) == (je._integrity is None)
        if te._integrity is not None:
            for f in ("mode", "weight_audit_every", "weight_blocks",
                      "kv_checksums", "shadow_every", "shadow_tol"):
                assert getattr(te._integrity.cfg, f) == \
                    getattr(je._integrity.cfg, f), f
            # one digest a (parameter, block), the reference's count
            assert len(te._integrity._probe_targets) == \
                len(je._integrity._probe_targets)
    finally:
        te._cache.shutdown_tier()
        je._cache.shutdown_tier()
    assert te.kv_tier is None or not te.kv_tier._worker.is_alive()


def test_kv_host_pages_needs_the_prefix_cache(models):
    jm, tm = models
    with pytest.raises(ValueError, match="prefix_cache"):
        JaxEngine(jm, num_pages=32, dtype=jnp.float32, kv_host_pages=8,
                  **GEOM)
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(tm, num_pages=32, device="cpu", kv_host_pages=8, **GEOM)
    with pytest.raises(ValueError, match="integrity="):
        Engine(tm, num_pages=32, device="cpu", integrity="paranoid", **GEOM)


@pytest.mark.parametrize("prompt,budget,kw,exc", [
    ([], 4, {}, ValidationError),
    ([1, 200], 4, {}, ValidationError),
    ([1.5, 2.0], 4, {}, ValidationError),
    ([1, 2], 0, {}, ValidationError),
    ([1, 2], 4, dict(temperature=-1.0), ValidationError),
    (list(range(123)), 4, {}, ValidationError),
])
def test_add_request_validation(models, prompt, budget, kw, exc):
    _, tm = models
    eng = Engine(tm, num_pages=32, device="cpu", **GEOM)
    with pytest.raises(exc):
        eng.add_request(np.asarray(prompt), budget, **kw)
    assert not eng._queue


def test_budget_clamped_below_max_position(models):
    _, tm = models
    eng = Engine(tm, num_pages=32, device="cpu", **GEOM)
    with pytest.warns(RuntimeWarning, match="clamped 4 -> 3"):
        req = eng.add_request(np.arange(120), 4)
    assert req.max_new_tokens == 3


def test_request_too_big_for_pool_rejected(models):
    _, tm = models
    eng = Engine(tm, num_pages=4, device="cpu", **GEOM)
    with pytest.raises(AdmissionRejected):
        eng.add_request(np.arange(30), 20)


def test_engine_rejects_mismatched_page_dtype(models):
    _, tm = models
    with pytest.raises(ValueError):
        Engine(tm, num_pages=32, device="cpu", dtype=torch.bfloat16,
               **GEOM)
