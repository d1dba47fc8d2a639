"""The port's ``LlamaForCausalLM`` against paddle_tpu's on
``tiny_llama_config`` (GQA: 4 heads over 2 kv heads) with the same weights
(``convert.state_dict_from_numpy`` over ``param_arrays``): cacheless
logits (f32, atol 1e-4), and the port's paged serving path — a ragged
prefill then decode steps — against its own cacheless logits at every
position."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny

from paddle_tpu_torch.convert import (init_llama, llama_from_numpy,
                                      state_dict_from_numpy)
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama2_7b,
                                           tiny_llama_config)
from paddle_tpu_torch.ops.cuda.paged_attention import PagedCacheState
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in param_arrays(jm).items()}
    tm = llama_from_numpy(tiny_llama_config(), arrays, device="cpu")
    return jm, tm, arrays


def test_parameter_names_match_one_for_one(pair):
    jm, tm, arrays = pair
    assert list(arrays) == [n for n, _ in tm.named_parameters()]
    for name, p in tm.named_parameters():
        assert tuple(p.shape) == arrays[name].shape, name
    assert "model.layers.0.self_attn.q_proj.weight" in arrays
    assert "lm_head.weight" in arrays


@pytest.mark.parametrize("shape", [(2, 11), (1, 1), (3, 24)])
def test_cacheless_logits_match(pair, shape):
    jm, tm, _ = pair
    ids = np.random.default_rng(sum(shape)).integers(0, 128, shape)
    want = np.asarray(jm(Tensor._wrap(jnp.asarray(ids)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == shape + (128,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _paged_states(cfg, b, ps, num_pages):
    khd = cfg.num_kv_heads * cfg.head_dim
    maxp = cfg.max_position // ps
    tables = torch.zeros((b, maxp), dtype=torch.int32)
    nxt = 1
    for r in range(b):
        for j in range(6):
            tables[r, j] = nxt
            nxt += 1
    assert nxt <= num_pages
    states = [PagedCacheState(torch.zeros((num_pages, ps, khd)),
                              torch.zeros((num_pages, ps, khd)), None,
                              tables, torch.zeros((b,), dtype=torch.int32),
                              ps)
              for _ in range(cfg.num_layers)]
    return states


def test_paged_prefill_and_decode_match_cacheless(pair):
    """Ragged prompts (5 and 9 tokens, padded to 12) prefill into the pages,
    then 6 decode steps: each step's logits equal the cacheless forward's
    last-position logits over the same unpadded sequence."""
    _, tm, _ = pair
    cfg = tm.config
    rng = np.random.default_rng(7)
    lens = [5, 9]
    seqs = [list(rng.integers(0, 128, n)) for n in lens]
    ids = np.zeros((2, 12), np.int64)
    for r, s in enumerate(seqs):
        ids[r, :len(s)] = s
    states = _paged_states(cfg, 2, 8, 16)
    valid = torch.tensor(lens, dtype=torch.int32)
    states = [st.replace(prefill_valid=valid) for st in states]
    with torch.no_grad():
        logits, states = tm(torch.from_numpy(ids), caches=states)
        for r in range(2):
            ref = tm(torch.tensor([seqs[r]]))[0, -1]
            np.testing.assert_allclose(logits[r, lens[r] - 1].numpy(),
                                       ref.numpy(), atol=1e-4, rtol=0)
        states = [st.replace(prefill_valid=None) for st in states]
        assert states[0].lengths.tolist() == lens
        for step in range(6):
            nxt = [int(rng.integers(0, 128)) for _ in range(2)]
            for r in range(2):
                seqs[r].append(nxt[r])
            logits, states = tm(torch.tensor(nxt)[:, None], caches=states)
            for r in range(2):
                ref = tm(torch.tensor([seqs[r]]))[0, -1]
                np.testing.assert_allclose(
                    logits[r, 0].numpy(), ref.numpy(), atol=1e-4, rtol=0,
                    err_msg=f"row {r} step {step}")
        assert states[0].lengths.tolist() == [len(s) for s in seqs]


def test_state_dict_from_numpy_casts_and_places():
    arrays = {"w": np.arange(6, dtype=np.float64).reshape(2, 3)}
    sd = state_dict_from_numpy(arrays, device="cpu", dtype="bf16")
    assert sd["w"].dtype == torch.bfloat16 and sd["w"].shape == (2, 3)


def test_init_llama_is_seeded():
    cfg = tiny_llama_config(num_layers=1)
    a = init_llama(cfg, seed=3, device="cpu", dtype=torch.float32)
    b = init_llama(cfg, seed=3, device="cpu", dtype=torch.float32)
    c = init_llama(cfg, seed=4, device="cpu", dtype=torch.float32)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    name = "model.layers.0.self_attn.q_proj.weight"
    assert torch.equal(pa[name], pb[name])
    assert not torch.equal(pa[name], pc[name])
    assert torch.all(pa["model.norm.weight"] == 1)
    assert abs(float(pa[name].detach().std())
               - cfg.initializer_range) < 5e-3


def test_llama2_7b_widths():
    cfg = llama2_7b()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.head_dim, cfg.max_position) == (4096, 32, 32, 128, 4096)
    assert 6.7e9 < cfg.num_params() < 6.8e9


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(tiny_llama_config())
