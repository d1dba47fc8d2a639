"""The port's ``nn.MultiHeadAttention`` and ``nn.Transformer*`` layers
against paddle_tpu's on the same inputs and weights (f32, tiny widths).

The JAX layers run as the JAX package's own tests run them on the CPU:
their unmasked attention is the naive composite (``_pallas_ok`` is False
off the TPU); the port's is the flash twin (kernel #2's plain version) and
the masked one plain PyTorch. The weights are random (biases and LayerNorm
parameters too, so every term counts), set on the JAX layer and carried
into the port by ``param_arrays`` and ``load_state_dict(strict=True)``:
the names and ``[in, out]`` layouts must match with no transposes.

Tolerance: 2e-5 absolute and relative on outputs of order one (f32
attention and GEMMs summed in other orders); 5e-5 after decode steps fed
their own caches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import param_arrays

import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import state_dict_from_numpy
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=5e-5, atol=5e-5)
D, H, FF = 32, 4, 64


def _randomize(layer, seed):
    """Weights N(0, 0.2); biases N(0, 0.1); LayerNorm scales 1 + N(0,
    0.1)."""
    r = np.random.default_rng(seed)
    for name, p in layer.named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = 0.2 * r.standard_normal(shape)
        else:
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            v = base + 0.1 * r.standard_normal(shape)
        p.set_value(jnp.asarray(v, jnp.float32))
    layer.eval()
    return layer


def _port(module, jax_layer):
    arrays = {k: np.asarray(v) for k, v in param_arrays(jax_layer).items()}
    module.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                           strict=True)
    return module.eval()


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data)
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _masks(s):
    """The reference's masks: none, the causal additive one, and a boolean
    one (True keeps) broadcast over heads."""
    causal = np.asarray(jnn.Transformer.generate_square_subsequent_mask(s)
                        ._data)
    keep = np.ones((2, 1, s, s), bool)
    keep[1, :, :, s - 3:] = False
    return {"none": None, "causal": causal, "bool": keep}


def _jt(a):
    return None if a is None else Tensor(jnp.asarray(a))


def _tt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def test_generate_square_subsequent_mask():
    want = np.asarray(jnn.Transformer.generate_square_subsequent_mask(5)
                      ._data)
    got = nn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_tanh_matches_jax():
    x = _x(0, 3, 7)
    np.testing.assert_allclose(F.tanh(torch.from_numpy(x)).numpy(),
                               _np(JF.tanh(Tensor(jnp.asarray(x)))), **TOL)


@pytest.mark.parametrize("mask", ["none", "causal", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_matches_jax(mask, normalize_before, activation):
    j = _randomize(jnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, activation=activation,
        normalize_before=normalize_before), 1)
    t = _port(nn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, activation=activation,
        normalize_before=normalize_before, device="cpu"), j)
    x = _x(2, 2, 12, D)
    m = _masks(12)[mask]
    want = j(Tensor(jnp.asarray(x)), src_mask=_jt(m))
    got = t(torch.from_numpy(x), src_mask=_tt(m))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("mask", ["none", "causal"])
def test_encoder_with_cache_matches_jax(mask):
    """``TransformerEncoder`` stepping with ``Cache``s from ``gen_cache``:
    each step's output and the grown caches; with the causal mask the last
    step equals the whole sequence's last rows."""
    j = _randomize(jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0), 2,
        jnn.LayerNorm(D)), 3)
    t = _port(nn.TransformerEncoder(
        nn.TransformerEncoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2,
        nn.LayerNorm(D, device="cpu")), j)
    x = _x(4, 2, 6, D)
    jc = j.gen_cache(Tensor(jnp.asarray(x)))
    tc = t.gen_cache(torch.from_numpy(x))
    for step in range(3):
        xs = x[:, 2 * step:2 * step + 2]
        sk = 2 * step + 2
        m = None
        if mask == "causal":  # the two new rows see every cached key
            m = np.asarray(jnn.Transformer.generate_square_subsequent_mask(
                sk)._data)[-2:]
        jo, jc = j(Tensor(jnp.asarray(xs)), src_mask=_jt(m), cache=jc)
        to, tc = t(torch.from_numpy(xs), src_mask=_tt(m), cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), **STEP_TOL)
        for a, b in zip(tc, jc):
            assert isinstance(a, nn.MultiHeadAttention.Cache)
            np.testing.assert_allclose(_np(a.k), _np(b.k), **STEP_TOL)
            np.testing.assert_allclose(_np(a.v), _np(b.v), **STEP_TOL)
    if mask == "causal":  # then the steps are the whole causal forward
        whole = t(torch.from_numpy(x), src_mask=_tt(_masks(6)["causal"]))
        np.testing.assert_allclose(_np(to), _np(whole[:, -2:]), **STEP_TOL)


@pytest.mark.parametrize("mask", ["none", "causal"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_jax(mask, normalize_before):
    j = _randomize(jnn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, normalize_before=normalize_before), 5)
    t = _port(nn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, normalize_before=normalize_before,
        device="cpu"), j)
    tgt, mem = _x(6, 2, 9, D), _x(7, 2, 11, D)
    m = _masks(9)[mask]
    mem_mask = np.zeros((2, 1, 1, 11), np.float32)
    mem_mask[0, ..., 7:] = -1e4
    want = j(Tensor(jnp.asarray(tgt)), Tensor(jnp.asarray(mem)),
             tgt_mask=_jt(m), memory_mask=_jt(mem_mask))
    got = t(torch.from_numpy(tgt), torch.from_numpy(mem), tgt_mask=_tt(m),
            memory_mask=_tt(mem_mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decoder_with_caches_matches_jax():
    """``TransformerDecoder`` decoding one token at a time: a growing
    ``Cache`` for self-attention and a ``StaticCache`` of the memory for
    cross-attention, from ``gen_cache``; each step equals the reference's
    and the last equals the cacheless forward's last row (causal)."""
    j = _randomize(jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(D, H, FF, dropout=0.0), 2), 8)
    t = _port(nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2),
        j)
    tgt, mem = _x(9, 2, 5, D), _x(10, 2, 7, D)
    jm, tm = Tensor(jnp.asarray(mem)), torch.from_numpy(mem)
    jc, tc = j.gen_cache(jm), t.gen_cache(tm)
    assert isinstance(tc[0][1], nn.MultiHeadAttention.StaticCache)
    for i in range(5):
        x = tgt[:, i:i + 1]
        jo, jc = j(Tensor(jnp.asarray(x)), jm, cache=jc)
        to, tc = t(torch.from_numpy(x), tm, cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), **STEP_TOL)
    whole = t(torch.from_numpy(tgt), tm, tgt_mask=_tt(_masks(5)["causal"]))
    np.testing.assert_allclose(_np(to[:, 0]), _np(whole[:, -1]), **STEP_TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    j = _randomize(jnn.Transformer(**kw), 11)
    t = _port(nn.Transformer(device="cpu", **kw), j)
    src, tgt = _x(12, 2, 10, D), _x(13, 2, 6, D)
    m = _masks(6)["causal"]
    want = j(Tensor(jnp.asarray(src)), Tensor(jnp.asarray(tgt)),
             tgt_mask=_jt(m))
    got = t(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=_tt(m))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mha_kdim_vdim_and_need_weights():
    """Key/value widths other than the embedding's, and ``need_weights``
    (the reference returns None for the weights)."""
    j = _randomize(jnn.MultiHeadAttention(D, H, kdim=16, vdim=24,
                                          need_weights=True), 14)
    t = _port(nn.MultiHeadAttention(D, H, kdim=16, vdim=24,
                                    need_weights=True, device="cpu"), j)
    q, k, v = _x(15, 2, 5, D), _x(16, 2, 8, 16), _x(17, 2, 8, 24)
    jo, jw = j(*(Tensor(jnp.asarray(a)) for a in (q, k, v)))
    to, tw = t(*(torch.from_numpy(a) for a in (q, k, v)))
    assert jw is None and tw is None
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)


def test_dropout_draws_from_the_generator():
    """In training the layer's dropouts draw from its generator: the same
    seed gives the same output, another seed another."""
    g = torch.Generator().manual_seed(0)
    layer = nn.TransformerEncoderLayer(D, H, FF, dropout=0.3, device="cpu",
                                       generator=g)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2)
    x = torch.from_numpy(_x(18, 2, 6, D))
    outs = []
    for seed in (1, 1, 2):
        g.manual_seed(seed)
        outs.append(layer(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
