"""The port's GPT (and LLaMA ``loss``) against paddle_tpu's eager tape on
the same weights: a 2-layer GPT of hidden 128 over 2 heads of 64, logits,
loss and the gradient of every parameter, on both attention routes with
``FLAGS_use_packed_attention`` set alike in the two packages:

* packed: the reference runs ``causal_flash_qkv`` (Pallas, interpret mode,
  hpb = 2), the port its ``causal_flash_qkv`` over the projection's views;
* general: ``F.flash_attention`` (the reference's naive attention off the
  TPU; the port's autograd Function over the flash twins).

Weights come from ``paddle_tpu.jit.param_arrays`` with the biases and norm
parameters randomised too, so every gradient is exercised. f32; logits
atol 1e-4, loss atol 1e-5, gradients atol 1e-5 relative to each
gradient's largest entry (summation order). LLaMA: ``tiny_llama_config``
(4 heads over 2 kv heads) ``loss`` gradients, the same tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny_llama

from paddle_tpu_torch.convert import (gpt_from_numpy, init_gpt,
                                      llama_from_numpy)
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         gpt2_medium, gpt2_small, gpt3_6p7b)
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.ops.cuda import causal_flash, flash_attention
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
            max_position=64)
B, S = 2, 32


def tiny_gpt_arrays(seed=0):
    """param_arrays of a tiny reference GPT, every entry randomised."""
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**TINY))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, a in param_arrays(jm).items():
        a = np.asarray(a)
        if a.ndim == 1:
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        arrays[name] = a
    return arrays


def load_jax(model, arrays):
    for name, p in model.named_parameters():
        p.set_value(jnp.asarray(arrays[name]))
    return model


def batch(seed, vocab, b=B, s=S, ignore=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    labels = rng.integers(0, vocab, (b, s))
    if ignore:
        labels[0, :3] = -100  # ignore_index entries count as 0
    return ids, labels


def jax_loss_and_grads(jm, ids, labels):
    jm.train()
    loss = jm.loss(Tensor._wrap(jnp.asarray(ids, jnp.int32)),
                   Tensor._wrap(jnp.asarray(labels, jnp.int32)))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    for _, p in jm.named_parameters():
        p.clear_grad()
    return float(loss.numpy()), grads


def port_loss_and_grads(tm, ids, labels):
    tm.train()
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in tm.named_parameters()}


def assert_grads_close(got, want, rel=1e-5):
    assert list(got) == list(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[name], w, atol=rel * scale, rtol=0,
                                   err_msg=name)


@pytest.fixture(autouse=True)
def no_jax_mesh():
    """Each test's JAX model runs on the JAX package's default mesh, as in
    a fresh process. A mesh with an ``mp`` axis that an earlier test's
    ``fleet.init`` left in this xdist worker makes the JAX GPT's ``loss``
    take the vocab-parallel cross entropy under ``shard_map``, whose bf16
    compile aborted the worker (ROADMAP C5)."""
    from paddle_tpu.distributed import parallel as jparallel

    prev = jparallel._global_mesh
    jparallel.set_mesh(None)
    yield
    jparallel.set_mesh(prev)


@pytest.fixture
def route_flags():
    """Sets ``FLAGS_use_packed_attention`` in both packages; restores."""
    saved = (jflags.get_flags("FLAGS_use_packed_attention"),
             tflags.get_flags("FLAGS_use_packed_attention"))

    def set_route(packed):
        jflags.set_flags({"FLAGS_use_packed_attention": packed})
        tflags.set_flags({"FLAGS_use_packed_attention": packed})

    yield set_route
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


@pytest.fixture(scope="module")
def gpt_pair():
    arrays = tiny_gpt_arrays()
    jm = load_jax(JaxGPT(JaxGPTConfig(**TINY)), arrays)
    tm = gpt_from_numpy(GPTConfig(**TINY), arrays, device="cpu")
    return jm, tm, arrays


def test_parameter_names_and_layouts_match(gpt_pair):
    _, tm, arrays = gpt_pair
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    for name, p in tm.named_parameters():
        assert tuple(p.shape) == arrays[name].shape, name
    assert "gpt.h.0.attn.qkv_proj.bias" in arrays
    assert "lm_head.weight" not in arrays  # tied to gpt.wte.weight


def test_logits_match(gpt_pair):
    jm, tm, _ = gpt_pair
    ids, _ = batch(1, TINY["vocab_size"])
    jm.eval()
    want = np.asarray(jm(Tensor._wrap(jnp.asarray(ids, jnp.int32)))._data)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "general"])
def test_loss_and_every_gradient_match(gpt_pair, route_flags, packed):
    jm, tm, _ = gpt_pair
    route_flags(packed)
    ids, labels = batch(2, TINY["vocab_size"])
    calls = []
    real = causal_flash.causal_flash_qkv

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    causal_flash.causal_flash_qkv = spy
    try:
        got_l, got_g = port_loss_and_grads(tm, ids, labels)
    finally:
        causal_flash.causal_flash_qkv = real
    assert len(calls) == (TINY["num_layers"] if packed else 0)
    want_l, want_g = jax_loss_and_grads(jm, ids, labels)
    assert abs(got_l - want_l) < 1e-5
    assert_grads_close(got_g, want_g)


def test_tied_embedding_gradient_sums_both_uses(gpt_pair, route_flags):
    """``wte``'s gradient is the embedding's plus the LM head's."""
    _, tm, _ = gpt_pair
    route_flags(False)
    ids, labels = batch(3, TINY["vocab_size"], ignore=False)
    _, grads = port_loss_and_grads(tm, ids, labels)
    tm.zero_grad(set_to_none=True)
    tm.train()
    x = tm.gpt(torch.from_numpy(ids))
    head_w = tm.gpt.wte.weight.detach().clone().requires_grad_()
    logits = x @ head_w.t()
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(labels).reshape(-1)).backward()
    both = tm.gpt.wte.weight.grad + head_w.grad
    np.testing.assert_allclose(grads["gpt.wte.weight"], both.numpy(),
                               atol=1e-6, rtol=0)
    assert float(head_w.grad.abs().sum()) > 0
    assert float(tm.gpt.wte.weight.grad.abs().sum()) > 0


def test_packed_route_is_auto_on_cuda_only(gpt_pair, route_flags):
    _, tm, _ = gpt_pair
    route_flags(None)
    attn = tm.gpt.h[0].attn
    x = torch.zeros((1, 16, TINY["hidden_size"]))
    assert not attn._packed_ok(x)  # CPU activations: the general route
    route_flags(True)
    assert attn._packed_ok(x)
    assert not attn._packed_ok(torch.zeros((1, 13, TINY["hidden_size"])))


def test_cache_arguments_raise(gpt_pair):
    """The caches are ported (``tests/test_torch_generate.py``); what is
    not a cache still raises: a missing layer cache, a tensor of neither
    cache layout."""
    _, tm, _ = gpt_pair
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="cache"):
        tm(ids, caches=[None])
    with pytest.raises(TypeError, match="cache"):
        tm.gpt.h[0](torch.zeros((1, 4, 128)), cache=torch.zeros(3),
                    time_step=3)


def test_init_gpt_is_seeded():
    cfg = GPTConfig(**dict(TINY, num_layers=1))
    a, b, c = (init_gpt(cfg, seed=s, device="cpu") for s in (3, 3, 4))
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    name = "gpt.h.0.attn.qkv_proj.weight"
    assert torch.equal(pa[name], pb[name])
    assert not torch.equal(pa[name], pc[name])
    assert torch.all(pa["gpt.h.0.ln_1.weight"] == 1)
    assert torch.all(pa["gpt.h.0.ln_1.bias"] == 0)
    assert torch.all(pa["gpt.h.0.attn.qkv_proj.bias"] == 0)
    assert abs(float(pa[name].std()) - cfg.initializer_range) < 5e-3


def test_configs_match_reference():
    from paddle_tpu.models import gpt as jgpt

    for ours, theirs in ((gpt2_small, jgpt.gpt2_small),
                         (gpt2_medium, jgpt.gpt2_medium),
                         (gpt3_6p7b, jgpt.gpt3_6p7b)):
        a, b = ours(), theirs()
        assert vars(a) == vars(b)
        assert a.num_params() == b.num_params()
    m = gpt2_medium()
    assert (m.hidden_size, m.num_layers, m.num_heads, m.head_dim) == \
        (1024, 24, 16, 64)


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        GPTForCausalLM(GPTConfig(**TINY))


# ------------------------------------------------------------------ LLaMA
@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(1)
    jm = JaxLlama(jax_tiny_llama())
    arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
    tm = llama_from_numpy(tiny_llama_config(), arrays, device="cpu")
    return jm, tm


def test_llama_loss_and_gradients_match(llama_pair):
    """GQA (4 heads over 2 kv heads): the port repeats the kv heads, then
    trains through ``F.flash_attention``'s Function, as the reference
    repeats them before its flash attention."""
    jm, tm = llama_pair
    ids, labels = batch(4, 128, s=24)
    before = flash_attention.flash_attention_bwd.launches
    got_l, got_g = port_loss_and_grads(tm, ids, labels)
    assert flash_attention.flash_attention_bwd.launches == before  # CPU
    want_l, want_g = jax_loss_and_grads(jm, ids, labels)
    assert abs(got_l - want_l) < 1e-5
    assert_grads_close(got_g, want_g)


def test_llama_moe_loss_is_refused():
    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.models.llama import tiny_moe_llama_config

    m = init_llama(tiny_moe_llama_config(), device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="MoE"):
        m.loss(ids, ids)
