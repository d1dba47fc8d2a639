"""The port's KV-cache generation against paddle_tpu's, on the CPU, on a
tiny GPT (2 heads of 64) and a tiny GQA LLaMA (4 heads over 2 kv heads)
holding the same f32 weights:

* per-step logits of a prefill and decode steps at ``time_step`` over the
  slab caches of ``init_caches``, user-allocated 5-D caches and
  ``PagedKVCache``s, against the JAX model's on the same caches (atol
  1e-4, the cacheless logits' bound in ``test_torch_llama.py``);
* ``generate`` token-exact against the JAX ``generate``: greedy, top-k and
  sampled (the key chain and the whole-array categorical reproduce
  ``jax.random``), and with int8 weights (``gpt_from_numpy(quant_algo=)``);
* greedy ``generate`` against the argmax of the cacheless forward;
* ``sampling.categorical_array`` against ``jax.random.categorical`` on 2-D
  logits with one key.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import param_arrays, state_arrays
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny_llama
from paddle_tpu.nn import quant as jquant
from paddle_tpu.ops.pallas.paged_attention import PagedKVCache as JaxPaged

from paddle_tpu_torch.convert import gpt_from_numpy, llama_from_numpy
from paddle_tpu_torch.inference import sampling
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.ops.cuda import decode_attention as TD
from paddle_tpu_torch.ops.cuda.paged_attention import PagedKVCache
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GPT_TINY = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
                max_position=64)
ATOL = 1e-4
PROMPT = 5


def _gpt_arrays(seed=0):
    """A tiny JAX GPT's parameters, biases and norms randomised too."""
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**GPT_TINY))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, a in param_arrays(jm).items():
        a = np.asarray(a)
        if a.ndim == 1:
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        arrays[name] = a
    for name, p in jm.named_parameters():
        p.set_value(jnp.asarray(arrays[name]))
    return jm, arrays


@functools.lru_cache(maxsize=None)
def _pair(family):
    if family == "gpt":
        jm, arrays = _gpt_arrays()
        tm = gpt_from_numpy(GPTConfig(**GPT_TINY), arrays, device="cpu")
    else:
        paddle.seed(0)
        jm = JaxLlama(jax_tiny_llama())
        arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
        tm = llama_from_numpy(tiny_llama_config(), arrays, device="cpu")
    jm.eval()
    tm.eval()
    return jm, tm


def _kv_shape(cfg):
    kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    return kv, cfg.hidden_size // cfg.num_heads


def _caches(jm, tm, layout, b, smax):
    """One cache per layer for each model, in ``layout``."""
    cfg = tm.config
    kv, hd = _kv_shape(cfg)
    n = cfg.num_layers
    if layout == "slab":
        return ([c for c in jm.init_caches(b, smax)],
                tm.init_caches(b, smax))
    if layout == "5d":
        z = np.zeros((2, b, kv, smax, hd), np.float32)
        return ([Tensor._wrap(jnp.asarray(z)) for _ in range(n)],
                [torch.zeros(z.shape) for _ in range(n)])
    kw = dict(num_pages=16, page_size=4, batch_size=b, num_kv_heads=kv,
              head_dim=hd, max_pages_per_seq=4)
    return ([JaxPaged(dtype=jnp.float32, **kw) for _ in range(n)],
            [PagedKVCache(dtype=torch.float32, device="cpu", **kw)
             for _ in range(n)])


@pytest.mark.parametrize("layout", ["slab", "5d", "paged"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_step_logits_match_jax(family, layout):
    """A 5-token prefill, then 4 decode steps on fixed tokens: the logits
    of every step equal the JAX model's on the same kind of cache."""
    jm, tm = _pair(family)
    vocab = tm.config.vocab_size
    rng = np.random.default_rng(len(family) + len(layout))
    ids = rng.integers(0, vocab, (2, PROMPT))
    jc, tc = _caches(jm, tm, layout, 2, 16)
    with torch.no_grad():
        want, jc = jm(Tensor._wrap(jnp.asarray(ids, jnp.int32)), caches=jc)
        got, tc = tm(torch.from_numpy(ids), caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   atol=ATOL, rtol=0)
        for t in range(PROMPT, PROMPT + 4):
            tok = rng.integers(0, vocab, (2, 1))
            want, jc = jm(Tensor._wrap(jnp.asarray(tok, jnp.int32)),
                          caches=jc, time_step=t)
            got, tc = tm(torch.from_numpy(tok), caches=tc, time_step=t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                       atol=ATOL, rtol=0, err_msg=f"t={t}")


def test_decode_steps_launch_through_the_slab_path(monkeypatch):
    """The GQA LLaMA's decode step on its slab caches reaches
    ``decode_attention_slab`` once per layer with native GQA (kv heads
    not repeated) and lengths ``time_step + 1``."""
    _, tm = _pair("llama")
    seen = []
    real = TD.decode_attention_slab

    def spy(q, kv_slab, lengths, scale=None):
        seen.append((q.shape, kv_slab.shape, lengths.tolist()))
        return real(q, kv_slab, lengths, scale)

    monkeypatch.setattr(TD, "decode_attention_slab", spy)
    caches = tm.init_caches(2, 16)
    with torch.no_grad():
        _, caches = tm(torch.zeros((2, 3), dtype=torch.long), caches=caches)
        tm(torch.zeros((2, 1), dtype=torch.long), caches=caches, time_step=3)
    cfg = tm.config
    assert seen == [((2, cfg.num_heads, cfg.head_dim),
                     (2, 2, 16, cfg.num_kv_heads * cfg.head_dim),
                     [4, 4])] * cfg.num_layers


SAMPLING = {"greedy": dict(temperature=0.0),
            "top_k": dict(temperature=0.8, top_k=5, seed=3),
            "sampled": dict(temperature=1.0, seed=7)}


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_matches_jax(family, mode):
    jm, tm = _pair(family)
    ids = np.random.default_rng(3).integers(0, tm.config.vocab_size,
                                            (2, PROMPT)).astype(np.int32)
    kw = dict(max_new_tokens=9, **SAMPLING[mode])
    want = np.asarray(jm.generate(Tensor._wrap(jnp.asarray(ids)), **kw)._data)
    got = tm.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int32 and got.shape == (2, PROMPT + 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_greedy_generate_matches_cacheless_argmax(family):
    _, tm = _pair(family)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, tm.config.vocab_size, (2, PROMPT)))
    out = tm.generate(ids, max_new_tokens=8, temperature=0.0)
    seq = ids
    with torch.no_grad():
        for _ in range(8):
            nxt = torch.argmax(tm(seq)[:, -1], dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


def test_generate_edges():
    """Training mode comes back; no new tokens returns the input; the cache
    capacity (``max_seq``) bounds the new tokens as in the reference."""
    jm, tm = _pair("gpt")
    ids = torch.zeros((1, PROMPT), dtype=torch.long)
    tm.train()
    try:
        out = tm.generate(ids, max_new_tokens=3, temperature=0.0)
        assert tm.training and out.shape == (1, PROMPT + 3)
    finally:
        tm.eval()
    assert torch.equal(tm.generate(ids, max_new_tokens=0), ids)
    got = tm.generate(ids, max_new_tokens=10, temperature=0.0,
                      max_seq=PROMPT + 4)
    want = jm.generate(Tensor._wrap(jnp.zeros((1, PROMPT), jnp.int32)),
                       max_new_tokens=10, temperature=0.0,
                       max_seq=PROMPT + 4)
    assert got.shape[1] == want.shape[1] == PROMPT + 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


def test_quantized_gpt_generate_matches_jax():
    """int8 weights cross over by ``gpt_from_numpy(quant_algo=)`` from the
    JAX model's parameters and buffers; greedy streams agree."""
    jm, _ = _gpt_arrays(seed=1)
    jm.eval()
    _, swapped = jquant.quantize_for_decode(jm, algo="weight_only_int8")
    arrays = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tm = gpt_from_numpy(GPTConfig(**GPT_TINY), arrays, device="cpu",
                        quant_algo="weight_only_int8")
    assert swapped == 4 * GPT_TINY["num_layers"]
    assert tm.gpt.h[0].attn.qkv_proj.weight.dtype == torch.int8
    ids = np.random.default_rng(6).integers(0, 96, (2, PROMPT)).astype(
        np.int32)
    want = jm.generate(Tensor._wrap(jnp.asarray(ids)), max_new_tokens=8,
                       temperature=0.0)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=8,
                      temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("seed", [0, 5, 12345])
@pytest.mark.parametrize("shape", [(1, 7), (3, 50), (8, 1000)])
def test_categorical_array_bit_exact(seed, shape):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    logits[0, : shape[1] // 2] = -np.inf  # a top-k mask
    key = np.array(sampling.key_from_seed(seed), np.uint32)
    want = np.asarray(jax.random.categorical(jnp.asarray(key),
                                             jnp.asarray(logits)))
    got = sampling.categorical_array(
        torch.from_numpy(key.astype(np.int64)), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
