"""Single-device MoE serving in the port against paddle_tpu's.

The JAX side runs its grouped expert matmul through ``grouped_matmul_ref``
(the ``ragged_dot`` twin): the installed JAX no longer has the Pallas TPU
compiler parameters its kernel names, so the kernel cannot run even in
interpret mode. The substitution is a ``monkeypatch`` of the attribute on
``sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]`` (the package's
``__init__`` re-exports a *function* of the same name, so an attribute
path would resolve to that function); nothing in ``paddle_tpu`` changes.

Held here: the port's plain twin against JAX's at the reference's own
kernel-parity cases (f32 atol = rtol = 1e-5, the same products summed in
another order; bf16 2e-2), ``_moe_forward`` at capacity factors 0.5 and
8.0 with the same stats vector, the stats tap, the tie rule of top-k, the
tiny MoE model's logits (f32, atol 1e-4), and the ``Engine`` — greedy and
sampled, chunked prefill, n-gram spec decoding, preemption and a heavy
drop rate — token-identical to the JAX engine with equal router stats.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas.grouped_matmul import (
    aligned_segment_offsets as jax_aligned_offsets)
from paddle_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul_ref as jax_grouped_ref)

from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.cuda import grouped_matmul as tgm

GEOM = dict(max_slots=2, page_size=8, chunk_size=4, max_chain=2)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def jax_grouped_through_ref(monkeypatch):
    mod = sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]
    monkeypatch.setattr(mod, "grouped_matmul", jax_grouped_ref)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_moe_llama_config())
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
    tm = llama_from_numpy(tllama.tiny_moe_llama_config(), arrays,
                          device="cpu")
    return jm, tm


# ------------------------------------------------------- the grouped twin
E, K, N = 4, 16, 32
GROUP_CASES = {
    "random": (40, [7, 13, 3, 17], None),
    "empty_groups": (24, [0, 24, 0, 0], None),
    "one_expert_0": (16, [16, 0, 0, 0], None),
    "one_expert_3": (16, [0, 0, 0, 16], None),
    "valid_with_zero": (32, [8, 8, 8, 8], [3, 8, 0, 5]),
    "rows_past_total": (30, [5, 5, 5, 5], None),
    "valid_and_past_total": (40, [9, 0, 6, 11], [4, 0, 6, 2]),
}


def _group_inputs(m, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, K)).astype(np.float32),
            r.standard_normal((E, K, N)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouped_twin_matches_jax(case, dtype):
    m, sizes, valid = GROUP_CASES[case]
    lhs, rhs = _group_inputs(m, seed=len(case))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jax_grouped_ref(
        jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt), jnp.asarray(sizes),
        None if valid is None else jnp.asarray(valid)).astype(jnp.float32))
    got = tgm.grouped_matmul_ref(
        torch.from_numpy(lhs).to(tdt), torch.from_numpy(rhs).to(tdt),
        torch.tensor(sizes, dtype=torch.int32),
        None if valid is None else torch.tensor(valid, dtype=torch.int32))
    assert got.dtype == tdt and got.shape == (m, N)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    # rows the reference zeroes are exactly zero here too
    dead = (want == 0).all(-1)
    assert not np.any(got[dead])


def test_grouped_wrapper_cpu_twin_and_validation():
    lhs, rhs = _group_inputs(20, seed=1)
    lt, rt = torch.from_numpy(lhs), torch.from_numpy(rhs)
    sizes = torch.tensor([5, 5, 5, 5], dtype=torch.int32)
    before = tgm.grouped_matmul.launches
    got = tgm.grouped_matmul(lt, rt, sizes)
    assert tgm.grouped_matmul.launches == before  # no kernel on the CPU
    assert torch.equal(got, tgm.grouped_matmul_ref(lt, rt, sizes))
    with pytest.raises(ValueError):
        tgm.grouped_matmul(lt[:, :15], rt, sizes)
    with pytest.raises(ValueError):
        tgm.grouped_matmul(lt, rt, sizes[:3])
    with pytest.raises(ValueError):
        tgm.grouped_matmul(lt, rt, sizes, sizes[:2])


@pytest.mark.parametrize("sizes", [[7, 13, 3, 17], [0, 0, 9, 1], [8, 8]])
def test_aligned_segment_offsets_match(sizes):
    ja, jo = jax_aligned_offsets(jnp.asarray(sizes))
    ta, to = tgm.aligned_segment_offsets(sizes)
    assert ta.tolist() == np.asarray(ja).tolist()
    assert to.tolist() == np.asarray(jo).tolist()


# ------------------------------------------------------------ the layer
def _layer_pair(cf):
    paddle.seed(7)
    jl = jllama.LlamaMoEMLP(jllama.tiny_moe_llama_config(
        capacity_factor=cf))
    jl.eval()
    tl = tllama.LlamaMoEMLP(tllama.tiny_moe_llama_config(
        capacity_factor=cf), device="cpu", dtype=torch.float32)
    tl.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in param_arrays(jl).items()}, strict=True)
    return jl, tl


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_forward_and_stats_match(cf):
    jl, tl = _layer_pair(cf)
    x = np.random.default_rng(11).standard_normal((2, 16, 64)).astype(
        np.float32)
    with jllama.moe_stats_tap() as jtap:
        want = jl.forward(jnp.asarray(x))
    with tllama.moe_stats_tap() as ttap, torch.no_grad():
        got = tl(torch.from_numpy(x))
    want = np.asarray(want._data if hasattr(want, "_data") else want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (js,), (ts,) = jtap, ttap
    js, ts = np.asarray(js), ts.numpy()
    e = 8
    assert ts.shape == (e + 3,)
    # kept per expert, dropped pairs and routed tokens are counts: equal
    assert np.array_equal(ts[:e + 1], js[:e + 1])
    assert ts[e + 2] == js[e + 2] == 32
    np.testing.assert_allclose(ts[e + 1], js[e + 1], rtol=1e-5)
    assert (ts[e] > 0) == (cf == 0.5)
    assert ts[:e].sum() + ts[e] == 2 * 32


def test_stats_tap_off_by_default_and_size():
    _, tl = _layer_pair(1.25)
    assert tllama._MOE_STATS_TAP is None
    out = tl(torch.zeros((1, 4, 64)))
    assert out.shape == (1, 4, 64) and tllama._MOE_STATS_TAP is None
    assert tllama.moe_stats_size(tllama.tiny_moe_llama_config()) == 8 + 3
    assert tllama.moe_stats_size(tllama.tiny_llama_config()) == 0


def test_top_k_takes_the_lower_index_on_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.5, 0.1, 0.2, 0.2]])
    vals, idx = tllama._top_k(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 1],
                                                       [0, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


def test_config_and_param_count_match():
    jc, tc = jllama.tiny_moe_llama_config(), tllama.tiny_moe_llama_config()
    assert tc.num_params() == jc.num_params()
    assert tc.moe_intermediate_size == jc.moe_intermediate_size == 64
    big = dict(num_experts=8, moe_top_k=2, num_kv_heads=8,
               intermediate_size=14336)
    assert tllama.LlamaConfig(**big).num_params() == \
        jllama.LlamaConfig(**big).num_params()
    assert tllama.LlamaConfig(num_experts=4).moe_intermediate_size == 11008
    with pytest.raises(ValueError):
        tllama.LlamaConfig(num_experts=2, moe_top_k=3)


def test_parameter_names_match(models):
    jm, tm = models
    names = list(param_arrays(jm))
    assert sorted(names) == sorted(n for n, _ in tm.named_parameters())
    assert "model.layers.1.mlp.experts_down" in names


@pytest.mark.parametrize("shape", [(1, 9), (2, 12)])
def test_moe_logits_match(models, shape):
    jm, tm = models
    ids = np.random.default_rng(5).integers(0, 128, shape)
    want = np.asarray(jm(Tensor._wrap(jnp.asarray(ids)))._data)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ the engine
def _serve_both(models, prompts, budget, temps=(0.0,), on_port=None, **kw):
    """Serve ``prompts`` through both engines; ``on_port(engine)`` may
    instrument the port's engine before it runs."""
    jm, tm = models
    je = JaxEngine(jm, dtype=jnp.float32, metrics=False, **GEOM, **kw)
    te = Engine(tm, device="cpu", **GEOM, **kw)
    if on_port is not None:
        on_port(te)
    out = []
    for eng in (je, te):
        reqs = [eng.add_request(p, budget, temperature=temps[i % len(temps)])
                for i, p in enumerate(prompts)]
        eng.run()
        # a recovered step fault can leave the streams equal all the same
        assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
        out.append(reqs)
    for j, t in zip(*out):
        assert t.failure_reason is None and j.failure_reason is None
        assert t.done and j.done
        assert t.tokens == j.tokens, f"request {t.rid}"
    js, ts = je.moe_stats(), te.moe_stats()
    assert ts["tokens_routed"] == js["tokens_routed"] > 0
    assert ts["pairs_dropped"] == js["pairs_dropped"]
    assert ts["expert_load"] == js["expert_load"]
    assert ts["pairs_kept"] == js["pairs_kept"]
    np.testing.assert_allclose(ts["router_entropy"], js["router_entropy"],
                               rtol=1e-5)
    return je, te, out[1]


def _prompts(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (int(rng.integers(6, 20)),))
            for _ in range(n)]


@pytest.fixture
def restore_capacity(models):
    yield
    for m in models:
        for blk in m.model.layers:
            blk.mlp.capacity_factor = 1.25


def test_engine_greedy_and_sampled_match(models):
    _, te, _ = _serve_both(models, _prompts(), 8, temps=(0.0, 0.7),
                           num_pages=64)
    assert "verify" not in te.moe_stats()
    assert te.moe_stats()["drop_frac"] > 0


def test_engine_chunked_matches(models):
    _serve_both(models, _prompts(), 8, num_pages=64, prefill_chunk=4)


def test_engine_spec_ngram_matches(models):
    """Streams and the reference's stats match; the verify forwards' stats,
    which the reference does not tap, come apart under ``"verify"``: every
    verify forward routes nb * (k + 1) tokens through each MoE layer."""
    _, tm = models
    rng = np.random.default_rng(9)
    span = rng.integers(0, 128, (6,))
    prompts = [np.tile(span, 3), np.concatenate([span, span[:4]])]
    seen = []

    def count_verify_tokens(eng):
        real = eng.runner.get_verify

        def get_verify(sampling):
            fn = real(sampling)

            def spy(tables, lengths, last_tok, drafts, *rest):
                seen.append(tables.shape[0] * (drafts.shape[1] + 1))
                return fn(tables, lengths, last_tok, drafts, *rest)
            return spy
        eng.runner.get_verify = get_verify

    _, te, _ = _serve_both(models, prompts, 12, num_pages=64, spec="ngram",
                           spec_k=4, on_port=count_verify_tokens)
    ver = te.moe_stats()["verify"]
    assert seen and ver["tokens_routed"] == \
        tm.config.num_layers * sum(seen)
    assert ver["pairs_kept"] + ver["pairs_dropped"] == \
        2 * ver["tokens_routed"]


def test_engine_preemption_matches(models):
    _, te, reqs = _serve_both(models, _prompts(3), 24, num_pages=9)
    assert te.preemptions >= 1 and any(r.retries for r in reqs)


def test_engine_capacity_override_matches(models, restore_capacity):
    _, te, _ = _serve_both(models, _prompts(), 8, num_pages=64,
                           capacity_factor=0.5)
    assert te.moe_stats()["drop_frac"] > 0.2
    assert all(b.mlp.capacity_factor == 0.5 for b in te.model.model.layers)


def test_engine_capacity_factor_validation(models, restore_capacity):
    _, tm = models
    dense = llama_from_numpy(
        tllama.tiny_llama_config(),
        {k: np.asarray(v) for k, v in param_arrays(jllama.LlamaForCausalLM(
            jllama.tiny_llama_config())).items()}, device="cpu")
    with pytest.raises(ValueError, match="capacity_factor"):
        Engine(dense, device="cpu", capacity_factor=1.0, **GEOM)
    with pytest.raises(ValueError, match="capacity_factor"):
        Engine(tm, device="cpu", capacity_factor=0.0, **GEOM)
    assert Engine(dense, device="cpu", **GEOM).moe_stats() == {}
    for knob in ("tp", "ep"):
        with pytest.raises(TypeError):
            Engine(tm, device="cpu", **{knob: 2}, **GEOM)
