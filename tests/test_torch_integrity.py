"""The port's integrity sentinel (``integrity=``, ``inference/integrity.py``)
against paddle_tpu's, on tiny LLaMA with the same weights (f32) and the
reference suite's geometry (``tests/test_integrity.py``: three slots, a
64-page pool of 8-token pages, the prefix cache on, a 16-token shared
prefix in two waves).

Each engine point is held against the JAX engine under the same
``FaultPlan``: the same pages flagged, the same requests failed, the same
quarantine, and every delivered stream equal to the JAX engine's and to
the uninjected run's. Both engines run on one synthetic step time, so
their steps, and the probes that ride them, agree.

The checksums themselves differ by design: the port's is an exact integer
sum, the reference's an f32 one (``integrity.py``), so what is compared is
which pages each flags, never the sums.
"""
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

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.inference.errors import IntegrityError
from paddle_tpu_torch.inference.integrity import (IntegrityConfig,
                                                  page_checksums)
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import REGISTRY, render_prometheus
from paddle_tpu_torch.serving import ServingFrontend

VOCAB = 128
PROMPT = list(range(1, 21))
SHARED = np.asarray(PROMPT[:16], np.int32)  # two full 8-token blocks


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
    kw.setdefault("max_slots", 3)
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("chunk_size", 4)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("integrity", "audit")
    return kw


def _synthetic_clock(eng):
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k, 3.0 + 2 * k)
    return eng


def _flagged(eng):
    """Record every page set the engine contains."""
    seen = []
    real = eng._contain_kv_corruption

    def contain(bad):
        seen.append(sorted(int(p) for p in bad))
        real(bad)

    eng._contain_kv_corruption = contain
    return seen


def _own_weights(models):
    """The models with a fresh copy of the port's weights: the port's
    ``bit-flip-weight`` writes into the model's tensors in place (the
    reference rebinds the engine's array), so a test that flips one must
    not share the module's model."""
    jm, _ = models
    return jm, llama_from_numpy(tiny_llama_config(),
                                {k: np.asarray(v)
                                 for k, v in param_arrays(jm).items()},
                                device="cpu")


def _both(models, **kw):
    """(jax engine, port engine, their flagged-page logs)."""
    je = _synthetic_clock(JaxEngine(models[0], dtype=jnp.float32,
                                    **_kw(kw)))
    te = _synthetic_clock(Engine(models[1], device="cpu", **_kw(kw)))
    return je, te, _flagged(je), _flagged(te)


def two_wave_workload(eng):
    """Wave 1 registers the shared prefix, wave 2 splices it."""
    rng = np.random.default_rng(0)
    w1 = [eng.add_request(
        np.concatenate([SHARED, rng.integers(0, VOCAB, (3 + i,))]), 8)
        for i in range(2)]
    eng.run()
    w2 = [eng.add_request(
        np.concatenate([SHARED, rng.integers(0, VOCAB, (5 + i,))]), 8)
        for i in range(2)]
    eng.run()
    return w1 + w2


@pytest.fixture(scope="module")
def clean(models):
    eng = Engine(models[1], device="cpu", **_kw(dict(integrity=None)))
    reqs = two_wave_workload(eng)
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.tokens) for r in reqs]


def _series(name, target, reg=REGISTRY):
    m = reg.get(name)
    if m is None:
        return 0.0
    return float(sum(leaf.value for key, leaf in m.series()
                     if f"target={target}" in str(key) or target in key))


def _fails(target, reg=REGISTRY):
    """Failed checks of ``target`` in the port's registry (or ``reg``,
    the reference's)."""
    return _series("paddle_tpu_integrity_failures_total", target, reg)


def _checks(target, reg=REGISTRY):
    return _series("paddle_tpu_integrity_checks_total", target, reg)


def _counts(target):
    """(port checks, port fails, JAX checks, JAX fails) of ``target``."""
    from paddle_tpu.observability import REGISTRY as JREG

    return (_checks(target), _fails(target), _checks(target, JREG),
            _fails(target, JREG))


def _corrupt(eng, page):
    """The engine's page damage (the port keeps it in the coordinator)."""
    fn = getattr(eng, "_corrupt_page", None) or eng._cache.corrupt_page
    fn(page)


# -------------------------------------------------------------- the config
@pytest.mark.parametrize("spec", [
    None, "off", False, "audit", True, "strict",
    {"shadow_every": 3, "weight_blocks": 0}, {"mode": "strict"}])
def test_config_coerce_matches_reference(spec):
    from paddle_tpu.inference.integrity import IntegrityConfig as JaxCfg

    got, want = IntegrityConfig.coerce(spec), JaxCfg.coerce(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert {f: getattr(got, f) for f in got.__slots__} == \
            {f: getattr(want, f) for f in want.__slots__}
    with pytest.raises(ValueError):
        IntegrityConfig.coerce("paranoid")


def test_page_checksum_is_exact_and_sees_one_bit():
    """The integer checksum: the same page gives the same sum in any wave
    and any order, and one flipped bit anywhere changes it."""
    g = torch.Generator().manual_seed(0)
    bufs = [torch.randn((9, 4, 16), generator=g).to(dt)
            for dt in (torch.float32, torch.bfloat16)]
    bufs.append(torch.randint(-128, 127, (9, 4, 16), dtype=torch.int8))
    alone = [int(page_checksums(bufs, torch.tensor([p]))) for p in range(9)]
    for width in (2, 3, 8):
        for start in range(0, 9 - width + 1):
            idx = torch.arange(start, start + width).flip(0)
            got = page_checksums(bufs, idx).tolist()
            assert got == [alone[int(p)] for p in idx]
    for j, b in enumerate(bufs):
        words = b.view(torch.int8).view(-1)
        per = words.numel() // 9  # bytes a page
        for pos in (0, per // 2 + 1, per - 1):
            for bit in (0, 7):
                at = 4 * per + pos
                old = words[at].clone()
                words[at] ^= -128 if bit == 7 else 1 << bit
                assert int(page_checksums(bufs, torch.tensor([4]))) != \
                    alone[4], (j, pos, bit)
                words[at] = old
        assert int(page_checksums(bufs, torch.tensor([4]))) == alone[4]


# ---------------------------------------------------------- KV page audits
def test_bit_flip_kv_detected_never_a_wrong_token(models, clean):
    """A silently flipped cached page is caught at splice, costs a miss,
    and every stream equals the uninjected run's, on both engines, which
    flag the same pages."""
    f0 = _fails("kv")
    je, te, jbad, tbad = _both(models, fault_plan="bit-flip-kv:at=1")
    out = []
    for eng in (je, te):
        reqs = two_wave_workload(eng)
        assert eng._fi.fired("bit-flip-kv") == 1
        assert all(r.done and not r.failed for r in reqs)
        assert eng._integrity.last_error is not None
        out.append(([list(r.tokens) for r in reqs], eng._pcache.hits,
                    eng._pcache.misses))
    assert _fails("kv") > f0, "corruption was not detected"
    assert tbad == jbad and tbad
    assert out[1] == out[0]
    assert out[1][0] == clean
    assert isinstance(te._integrity.last_error, IntegrityError)


def test_corrupted_after_registration_caught_before_splice(models, clean):
    """A page corrupted while parked (registered, idle) is caught when the
    next admission would splice it."""
    f0 = _fails("kv")
    je, te, jbad, tbad = _both(models)
    out = []
    for eng in (je, te):
        rng = np.random.default_rng(0)
        w1 = [eng.add_request(
            np.concatenate([SHARED, rng.integers(0, VOCAB, (3 + i,))]), 8)
            for i in range(2)]
        eng.run()
        idle = sorted(p for p in eng._pcache._by_page
                      if int(eng._page_ref[p]) == 0)
        assert idle, "no parked cached page to corrupt"
        _corrupt(eng, idle[0])
        w2 = [eng.add_request(
            np.concatenate([SHARED, rng.integers(0, VOCAB, (5 + i,))]), 8)
            for i in range(2)]
        eng.run()
        reqs = w1 + w2
        assert all(r.done and not r.failed for r in reqs)
        assert eng._pcache.misses >= 1
        out.append([list(r.tokens) for r in reqs])
    assert _fails("kv") > f0
    assert tbad == jbad and tbad
    assert out[1] == out[0] == clean


def test_active_referent_is_preempted_and_exact(models):
    """A corrupt page still referenced by an active slot: that request is
    preempted and recomputes, its stream unchanged, on both engines."""
    ref = Engine(models[1], device="cpu",
                 **_kw(dict(integrity=None, chunk_size=1, max_chain=1)))
    long_req = ref.add_request(SHARED, 24)
    ref.run()
    want = list(long_req.tokens)
    je, te, jbad, tbad = _both(models, chunk_size=1, max_chain=1)
    out = []
    for eng in (je, te):
        pre0 = eng._m.preemptions.value
        req = eng.add_request(SHARED, 24)
        for _ in range(2):
            eng.step()
        assert not req.done
        cached = sorted(eng._pcache._by_page)
        assert cached
        _corrupt(eng, cached[0])
        req2 = eng.add_request(SHARED, 8)
        eng.run()
        assert req.done and not req.failed and req2.done and not req2.failed
        assert eng._m.preemptions.value > pre0
        out.append((list(req.tokens), list(req2.tokens)))
    assert out[0][0] == want
    assert out[1] == out[0]
    assert tbad == jbad and tbad


def test_zero_overlap_traffic_unaffected(models):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, (9 + i,)) for i in range(3)]
    out = {}
    for key, integ in (("off", None), ("on", "audit")):
        eng = Engine(models[1], device="cpu", **_kw(dict(integrity=integ)))
        reqs = [eng.add_request(p, 8) for p in prompts]
        eng.run()
        assert all(r.done and not r.failed for r in reqs)
        out[key] = [list(r.tokens) for r in reqs]
    assert out["on"] == out["off"]


# ----------------------------------------------------------- weight audits
def _changed(params_before, params_after):
    """(param index, flat element) of every element that changed."""
    out = []
    for i, (a, b) in enumerate(zip(params_before, params_after)):
        a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
        out += [(i, int(k)) for k in np.flatnonzero(a != b)]
    return out


def _host(p):
    """A host copy (never a view: the port flips in place)."""
    return (p.detach().clone().cpu().numpy() if isinstance(p, torch.Tensor)
            else np.array(p))


def test_bit_flip_weight_quarantines_and_fail_stops(models):
    """The same seed flips the same bit of the same element in both
    engines; the audit catches it, the engine quarantines and mints
    nothing more, and the streams up to then are equal."""
    f0 = _fails("weights")
    je, te, _, _ = _both(_own_weights(models),
                         fault_plan="bit-flip-weight:at=1",
                         chunk_size=1, max_chain=1,
                         integrity={"mode": "audit",
                                    "weight_audit_every": 1})
    flips, streams = [], []
    for eng in (je, te):
        before = [_host(p) for p in eng._params]
        req = eng.add_request(np.asarray(PROMPT, np.int32), 16)
        eng.run()  # returns early on quarantine
        assert eng._fi.fired("bit-flip-weight") == 1
        wd = eng._watchdog
        assert wd.quarantined and not wd.ready
        assert wd.readiness()["quarantined"] and wd.mode == "quarantined"
        n = len(req.tokens)
        assert not req.done and not req.failed
        for _ in range(3):
            eng.step()
        assert len(req.tokens) == n
        flips.append(_changed(before, [_host(p) for p in eng._params]))
        streams.append(list(req.tokens))
    assert _fails("weights") > f0
    assert len(flips[1]) == 1 and flips[1] == flips[0]
    assert streams[1] == streams[0]


def test_bit_flip_weight_is_written_in_place(models):
    """The flip lands in the tensor the model (and a captured graph)
    reads: no parameter is rebound."""
    _, te, _, _ = _both(_own_weights(models),
                        fault_plan="bit-flip-weight:at=1",
                        integrity={"mode": "audit", "weight_audit_every": 1})
    ptrs = [p.data_ptr() for p in te._params]
    model_params = [p for _, p in te.model.named_parameters()]
    te.add_request(np.asarray(PROMPT, np.int32), 8)
    te.run()
    assert te._watchdog.quarantined
    assert [p.data_ptr() for p in te._params] == ptrs
    assert all(a is b for a, b in zip(model_params, te._params))


def test_frontend_readiness_carries_quarantine(models):
    je, te, _, _ = _both(_own_weights(models),
                         fault_plan="bit-flip-weight:at=1",
                         integrity={"mode": "audit", "weight_audit_every": 1})
    for eng, cls in ((je, JaxFrontend), (te, ServingFrontend)):
        fe = cls(eng)
        eng.add_request(np.asarray(PROMPT, np.int32), 4)
        eng.run()
        ready = fe.readiness()
        assert ready["quarantined"] is True
        assert ready["ready"] is False


def test_clean_engine_never_quarantines(models, clean):
    c0 = _counts("weights")
    je, te, _, _ = _both(models, integrity={"mode": "audit",
                                            "weight_audit_every": 1})
    out = []
    for eng in (je, te):
        reqs = two_wave_workload(eng)
        assert not eng._watchdog.quarantined
        out.append([list(r.tokens) for r in reqs])
    assert out[1] == out[0] == clean
    d = [a - b for a, b in zip(_counts("weights"), c0)]
    assert d[0] > 0 and d[1] == 0 and d[:2] == d[2:]


def test_probe_fault_is_a_failed_sentinel_check(models):
    """A probe that raises is counted as a failed ``sentinel`` check and
    kept in ``last_error``; the step it rode goes on."""
    je, te, _, _ = _both(models, integrity={"mode": "audit",
                                            "weight_audit_every": 1})

    def boom(*a, **k):
        raise OSError("injected fetch failure")

    c0 = _counts("sentinel")
    for eng in (je, te):
        eng.runner.fetch_param_slice = boom
        req = eng.add_request(np.asarray(PROMPT, np.int32), 6)
        eng.run()
        assert req.done and not req.failed
        assert isinstance(eng._integrity.last_error.__cause__, OSError)
    d = [a - b for a, b in zip(_counts("sentinel"), c0)]
    assert d[0] == d[1] > 0 and d[:2] == d[2:]


# -------------------------------------------------------- shadow recompute
def test_clean_streams_pass_the_shadow(models, clean):
    c0 = _counts("shadow")
    je, te, _, _ = _both(models, max_chain=1,
                         integrity={"mode": "strict", "shadow_every": 1,
                                    "weight_audit_every": 0})
    out = []
    for eng in (je, te):
        reqs = two_wave_workload(eng)
        assert all(r.done and not r.failed for r in reqs)
        out.append([list(r.tokens) for r in reqs])
    d = [a - b for a, b in zip(_counts("shadow"), c0)]
    assert d[0] > 0 and d[1] == 0 and d[:2] == d[2:]
    assert out[1] == out[0] == clean


def test_divergent_token_is_caught_and_failed(models):
    """The delivered token tampered to the contiguous forward's argmin:
    the shadow fails that request with ``integrity`` on both engines."""
    je, te, _, _ = _both(models, chunk_size=1, max_chain=1,
                         integrity={"mode": "strict", "shadow_every": 1,
                                    "weight_audit_every": 0})
    tm = models[1]
    for eng in (je, te):
        req = eng.add_request(np.asarray(PROMPT, np.int32), 16)
        for _ in range(3):
            eng.step()
        assert req.tokens and not req.done
        ids = np.concatenate([np.asarray(PROMPT, np.int32),
                              np.asarray(req.tokens[:-1], np.int32)])
        with torch.no_grad():
            row = tm(torch.as_tensor(ids[None, :]))[0, -1].numpy()
        req.tokens[-1] = int(row.argmin())
        assert eng._integrity.shadow_check() is False
        assert req.failed and req.failure_reason == "integrity"
    assert isinstance(req.failure, IntegrityError)


# --------------------------------------------------------------- telemetry
def test_counters_are_scrape_visible(models):
    _, te, _, _ = _both(models, fault_plan="bit-flip-kv:at=1")
    two_wave_workload(te)
    text = render_prometheus()
    assert "paddle_tpu_integrity_checks_total" in text
    assert 'target="kv"' in text
    assert "paddle_tpu_integrity_failures_total" in text


def test_sentinel_off_by_default_and_free(models):
    eng = Engine(models[1], device="cpu", max_slots=2, num_pages=64,
                 page_size=8, chunk_size=4)
    assert eng._integrity is None
