"""Weight-only int8/int4 serving in the port against paddle_tpu's.

``nn.quant.weight_quantize`` must give the same int8 bytes and f32 scales;
``unpack_int4``, the kernel's plain twin ``quant_matmul_ref`` and the
dequantize-then-matmul twin ``quant_matmul_xla`` are held against their
JAX functions (f32 atol = rtol = 1e-5: the same products, summed in
another order; bf16 2e-2: outputs rounded to bf16, and the port's
``quant_matmul_xla`` rounds a bf16 product to bf16 before its scale).
``quantize_for_decode`` swaps the same Linears; a quantized tiny LLaMA
(weights AND buffers from the JAX model through ``convert``) gives the
same logits (f32, atol 1e-4) and, served through the ``Engine``, the same
token streams as the JAX engine: int8, int4, int4 with int8 pages, and
int8 with chunked prefill and with n-gram speculative decoding. On the
CPU both packages take their XLA-style path (the reference's ``auto``
rule), so the kernel's twin is held on its own here and the kernel
against it on the card (``tests/test_torch_cuda_kernels.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import state_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.nn import quant as jquant
from paddle_tpu.ops.pallas.quant_matmul import (quant_matmul_ref as
                                                jax_quant_matmul_ref)
from paddle_tpu.ops.pallas.quant_matmul import unpack_int4 as jax_unpack_int4

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import llama_from_numpy, state_dict_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           tiny_llama_config)
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.ops.cuda import quant_matmul as tqm
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ALGOS = ["weight_only_int8", "weight_only_int4"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GEOM = dict(max_slots=2, page_size=8, chunk_size=4)


def _weight(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("shape", [(64, 48), (128, 1), (2, 7), (256, 130)])
def test_weight_quantize_bit_equal(algo, shape):
    w = _weight(shape, 1)
    jq, js = jquant.weight_quantize(jnp.asarray(w), algo=algo)
    tq, ts = tquant.weight_quantize(torch.from_numpy(w), algo=algo)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq._data))
    assert np.array_equal(ts.numpy(), np.asarray(js._data))


def test_weight_quantize_bf16_input_and_zero_columns():
    w = _weight((32, 16), 2)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    for algo in ALGOS:
        jq, js = jquant.weight_quantize(
            jnp.asarray(w, jnp.bfloat16), algo=algo)
        tq, ts = tquant.weight_quantize(
            torch.from_numpy(w).to(torch.bfloat16), algo=algo)
        assert np.array_equal(tq.numpy(), np.asarray(jq._data))
        assert np.array_equal(ts.numpy(), np.asarray(js._data))


def test_weight_quantize_rejects_odd_int4_and_unknown_algo():
    with pytest.raises(ValueError):
        tquant.weight_quantize(torch.zeros((3, 4)), "weight_only_int4")
    with pytest.raises(NotImplementedError):
        tquant.weight_quantize(torch.zeros((4, 4)), "weight_only_int2")


def test_unpack_int4_equal():
    packed = np.random.default_rng(3).integers(
        -128, 128, (24, 10)).astype(np.int8)
    want = np.asarray(jax_unpack_int4(jnp.asarray(packed)))
    got = tqm.unpack_int4(torch.from_numpy(packed))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert int(got.min()) >= -8 and int(got.max()) <= 7


def _mm_inputs(dtype, algo, m=5, k=64, n=48, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, sc = tquant.weight_quantize(torch.from_numpy(_weight((k, n), seed)),
                                    algo=algo)
    bias = rng.standard_normal((n,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (x, wq.numpy(), sc.numpy(), bias, jdt, tdt)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_matmul_ref_matches_jax(dtype, algo, with_bias):
    x, wq, sc, bias, jdt, tdt = _mm_inputs(dtype, algo)
    wd = algo[-4:]
    b = bias if with_bias else None
    want = jax_quant_matmul_ref(jnp.asarray(x, jdt), jnp.asarray(wq),
                                jnp.asarray(sc),
                                None if b is None else jnp.asarray(b),
                                weight_dtype=wd)
    got = tqm.quant_matmul_ref(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(wq), torch.from_numpy(sc),
                               None if b is None else torch.from_numpy(b),
                               weight_dtype=wd)
    assert got.dtype == tdt
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_matmul_xla_matches_jax(dtype, algo, with_bias):
    x, wq, sc, bias, jdt, tdt = _mm_inputs(dtype, algo, m=7)
    wd = algo[-4:]
    b = bias if with_bias else None
    want = jquant.quant_matmul_xla(jnp.asarray(x, jdt), jnp.asarray(wq),
                                   jnp.asarray(sc),
                                   None if b is None else jnp.asarray(b),
                                   weight_dtype=wd)
    got = tquant.quant_matmul_xla(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
        torch.from_numpy(sc), None if b is None else torch.from_numpy(b),
        weight_dtype=wd)
    assert got.dtype == tdt
    _close(got, want.astype(jnp.float32), dtype)


def test_cpu_wrapper_takes_the_twin_and_validates():
    x, wq, sc, bias, _, _ = _mm_inputs("float32", "weight_only_int4")
    before = tqm.quant_matmul.launches
    xt = torch.from_numpy(x).reshape(1, 5, 64)
    got = tqm.quant_matmul(xt, torch.from_numpy(wq), torch.from_numpy(sc),
                           weight_dtype="int4")
    assert tqm.quant_matmul.launches == before  # no kernel on the CPU
    want = tqm.quant_matmul_ref(xt, torch.from_numpy(wq),
                                torch.from_numpy(sc), weight_dtype="int4")
    assert got.shape == (1, 5, 48) and torch.equal(got, want)
    with pytest.raises(ValueError):
        tqm.quant_matmul(xt[..., :63], torch.from_numpy(wq),
                         torch.from_numpy(sc), weight_dtype="int4")
    with pytest.raises(NotImplementedError):
        tqm.quant_matmul(xt, torch.from_numpy(wq), torch.from_numpy(sc),
                         weight_dtype="fp8")


@pytest.mark.parametrize("rows,k,n,int4", [(8, 4096, 4096, False),
                                           (40, 11008, 4096, True),
                                           (256, 4096, 32000, False),
                                           (1, 130, 1, True),
                                           (3, 100, 7, False)])
def test_split_plan_covers_k(rows, k, n, int4):
    splits, kps = tqm.split_plan(rows, k, n, int4)
    assert splits >= 1 and kps >= 1
    assert (splits - 1) * kps < k <= splits * kps
    assert kps % 8 == 0


def test_quant_backend_auto_rule():
    assert tquant.quant_backend(8, "cpu") == "xla"
    assert tquant.quant_backend(None, None) == "xla"
    assert tquant.quant_backend(256, torch.device("cuda", 0)) == "cuda"
    assert tquant.quant_backend(257, torch.device("cuda", 0)) == "xla"
    assert tquant.quant_backend(None, "cuda:0") == "cuda"


def _jax_quantized(algo):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    _, swapped = jquant.quantize_for_decode(jm, algo=algo)
    return jm, swapped


@functools.lru_cache(maxsize=None)
def _pair(algo):
    """The JAX tiny LLaMA quantized with ``algo`` and its port twin, built
    from the JAX model's parameters and buffers."""
    jm, swapped = _jax_quantized(algo)
    arrays = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tm = llama_from_numpy(tiny_llama_config(), arrays, device="cpu",
                          quant_algo=algo)
    return jm, tm, swapped, algo


@pytest.fixture(params=ALGOS)
def qpair(request):
    return _pair(request.param)


@pytest.fixture
def int8_pair():
    return _pair("weight_only_int8")


@pytest.mark.parametrize("kw", [dict(), dict(min_features=100),
                                dict(include="mlp")])
@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_for_decode_swap_counts(algo, kw):
    kw = dict(kw)
    if kw.get("include"):
        kw["include"] = lambda name, _layer: ".mlp." in name
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    _, jn = jquant.quantize_for_decode(jm, algo=algo, **kw)
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    for p in tm.parameters():
        torch.nn.init.normal_(p)
    _, tn = tquant.quantize_for_decode(tm, algo=algo, **kw)
    assert tn == jn > 0
    swapped = [n for n, mod in tm.named_modules()
               if isinstance(mod, tquant.WeightOnlyLinear)]
    assert len(swapped) == tn
    if not kw:
        assert tn == 15 and "lm_head" in swapped


def test_int4_skips_odd_in_features():
    seq = torch.nn.Sequential(pnn.Linear(3, 4, device="cpu"),
                              pnn.Linear(4, 4, device="cpu"))
    for p in seq.parameters():
        torch.nn.init.normal_(p)
    _, n = tquant.quantize_for_decode(seq, algo="weight_only_int4")
    assert n == 1 and isinstance(seq[0], pnn.Linear)
    assert isinstance(seq[1], tquant.WeightOnlyLinear)


def test_quantized_model_buffers_and_dtype(qpair):
    _, tm, swapped, algo = qpair
    lin = tm.model.layers[0].self_attn.q_proj
    assert isinstance(lin, tquant.WeightOnlyLinear)
    assert lin.weight_dtype == algo[-4:]
    names = dict(tm.named_buffers())
    assert names["lm_head.weight"].dtype == torch.int8
    assert names["lm_head.weight_scale"].dtype == torch.float32
    assert "lm_head.weight" not in dict(tm.named_parameters())
    # the embedding carries the model's dtype and device, not lm_head
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"
    assert swapped == 15


def test_state_dict_from_numpy_keeps_ints_and_scales():
    arrays = {"a.weight": np.arange(6, dtype=np.int8).reshape(2, 3),
              "a.weight_scale": np.full((3,), 0.5, np.float32),
              "b.weight": np.ones((2, 2), np.float64)}
    sd = state_dict_from_numpy(arrays, device="cpu", dtype="bf16")
    assert sd["a.weight"].dtype == torch.int8
    assert sd["a.weight_scale"].dtype == torch.float32
    assert sd["b.weight"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 7), (2, 12)])
def test_quantized_logits_match(qpair, shape):
    jm, tm, _, _ = qpair
    ids = np.random.default_rng(5).integers(0, 128, shape)
    want = np.asarray(jm(Tensor._wrap(jnp.asarray(ids)))._data)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _serve_both(qpair, spec, num_pages=64, **kw):
    jm, tm, _, _ = qpair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (n,)) for n, *_ in spec]
    je = JaxEngine(jm, num_pages=num_pages, dtype=jnp.float32,
                   metrics=False, **GEOM, **kw)
    te = Engine(tm, num_pages=num_pages, device="cpu", **GEOM, **kw)
    out = []
    for eng in (je, te):
        reqs = [eng.add_request(p, m, temperature=t, seed=s)
                for p, (_, m, t, s) in zip(prompts, spec)]
        eng.run()
        # a recovered step fault can leave the streams equal all the same
        assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
        out.append(reqs)
    for j, t in zip(*out):
        assert t.failure_reason is None and j.failure_reason is None
        assert t.done and j.done
        assert t.tokens == j.tokens, f"request {t.rid}"
    return te, out[1]


SPEC = [(5, 12, 0.0, None), (12, 10, 0.8, 3), (9, 14, 0.0, None),
        (3, 9, 1.0, 7)]


def test_engine_streams_match(qpair):
    """int8 and int4 weights over f32 pages."""
    _serve_both(qpair, SPEC)


def test_engine_streams_match_int8_pages(qpair):
    """``paged_int4w`` (and int8 weights) with int8 KV pages."""
    te, _ = _serve_both(qpair, SPEC, quantized_cache=True)
    assert te._cache.k_pages[0].dtype == torch.int8


def test_engine_streams_match_chunked(int8_pair):
    _serve_both(int8_pair, [(14, 8, 0.0, None), (9, 10, 0.8, 5),
                        (20, 6, 0.0, None)], prefill_chunk=4)


def test_engine_streams_match_spec_ngram(int8_pair):
    rng = np.random.default_rng(9)
    span = rng.integers(0, 128, (6,))
    jm, tm, _, _ = int8_pair
    prompts = [np.tile(span, 3), np.concatenate([span, span[:4]])]
    je = JaxEngine(jm, num_pages=64, dtype=jnp.float32, metrics=False,
                   spec="ngram", spec_k=4, **GEOM)
    te = Engine(tm, num_pages=64, device="cpu", spec="ngram", spec_k=4,
                **GEOM)
    out = []
    for eng in (je, te):
        reqs = [eng.add_request(p, 12) for p in prompts]
        eng.run()
        # a recovered step fault can leave the streams equal all the same
        assert eng._watchdog.last_fault is None, eng._watchdog.last_fault
        out.append([r.tokens for r in reqs])
    assert out[0] == out[1]
    assert te._spec.verify_steps > 0
