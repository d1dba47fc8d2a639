"""The port's fused transformer layers (``incubate.nn``), the seven fused
functional ops and ``F.scaled_dot_product_attention`` against paddle_tpu's
on the same inputs and weights (f32, tiny widths).

The JAX layers run as the JAX package's own tests run them on the CPU:
their context attention is the naive composite, their decode caches go
through the Pallas kernels in interpret mode or their ``jnp`` twins. The
weights are random (biases and LN parameters too, so every term counts),
set on the JAX layer and carried into the port by
``convert.fused_multi_transformer_from_numpy`` (the per-layer lists) or by
the state dict (the other layers), with no transposes.

Tolerances: 2e-5 absolute and relative on outputs of order one (f32
attention and GEMMs summed in other orders); 1e-4 after decode steps fed
their own outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.incubate.nn import (FusedFeedForward as JaxFFN,
                                    FusedMultiHeadAttention as JaxMHA,
                                    FusedMultiTransformer as JaxFMT,
                                    FusedTransformerEncoderLayer as JaxEnc)
from paddle_tpu.jit import param_arrays
from paddle_tpu.ops.pallas.paged_attention import (
    PagedCacheState as JaxState, PagedKVCache as JaxPagedKV)

import paddle_tpu_torch.incubate.nn.functional as IF
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.convert import (fused_multi_transformer_from_numpy,
                                      init_fused_multi_transformer,
                                      state_dict_from_numpy)
from paddle_tpu_torch.incubate.nn import (FusedFeedForward,
                                          FusedMultiHeadAttention,
                                          FusedMultiTransformer,
                                          FusedTransformerEncoderLayer)
from paddle_tpu_torch.incubate.nn.layer.fused_transformer import _LISTS
from paddle_tpu_torch.ops.cuda.decode_attention import make_kv_slab
from paddle_tpu_torch.ops.cuda.paged_attention import (PagedCacheState,
                                                       PagedKVCache)
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
EMB, NH, FF, LAYERS = 32, 4, 64, 2
HD = EMB // NH


def _randomize(layer, seed):
    """Random values for every parameter of a JAX layer: weights N(0, 0.2),
    biases N(0, 0.1), LN scales 1 + N(0, 0.1)."""
    r = np.random.default_rng(seed)
    for name, p in layer.named_parameters():
        shape = tuple(p.shape)
        scale = 0.1 if ("bias" in name or "scale" in name) else 0.2
        base = 1.0 if "scale" in name else 0.0
        p.set_value(jnp.asarray(base + scale * r.standard_normal(shape),
                                jnp.float32))
    layer.eval()
    return layer


def _jnp(t):
    return np.asarray(t._data if isinstance(t, Tensor) else t)


def _port(layer_cls, jax_layer, *args, **kw):
    m = layer_cls(*args, device="cpu", **kw)
    arrays = {k: np.asarray(v) for k, v in param_arrays(jax_layer).items()}
    m.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                      strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def fmt():
    paddle.seed(0)
    jm = _randomize(JaxFMT(EMB, NH, FF, num_layers=LAYERS), 1)
    lists = {name: [_jnp(p) for p in getattr(jm, name)] for name in _LISTS}
    tm = fused_multi_transformer_from_numpy(lists, device="cpu")
    return jm, tm


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_run(m, x, **kw):
    out = m(Tensor._wrap(jnp.asarray(x)), **kw)
    return out


# ------------------------------------------------------ FusedMultiTransformer
def test_from_numpy_keeps_names_and_layouts(fmt):
    jm, tm = fmt
    want = param_arrays(jm)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == tuple(np.shape(a)), name
        np.testing.assert_array_equal(got[name].detach().numpy(),
                                      np.asarray(a))


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_fmt_forward_matches_jax(fmt, mask):
    """No cache: the context attention (the flash path, or the masked
    softmax under a padding-and-causal mask)."""
    jm, tm = fmt
    b, s = 2, 8
    x = _x(2, (b, s, EMB))
    jmask = tmask = None
    if mask is not None:
        keep = np.tril(np.ones((s, s), bool))[None, None].repeat(b, 0)
        keep[1, :, :, 6:] = False  # row 1 pads its last two keys
        if mask == "bool":
            jmask, tmask = jnp.asarray(keep), torch.from_numpy(keep)
        else:
            add = np.where(keep, 0.0, -1e9).astype(np.float32)
            jmask, tmask = jnp.asarray(add), torch.from_numpy(add)
    want = _jnp(_jax_run(jm, x, attn_mask=jmask))
    got = tm(torch.from_numpy(x), attn_mask=tmask).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fmt_matches_unfused_composite(fmt):
    """The fused stack against a per-op composite of plain torch ops on the
    port layer's own weights (the reference's test strategy)."""
    _, tm = fmt
    b, s = 2, 8
    x = torch.from_numpy(_x(3, (b, s, EMB)))
    got = tm(x)
    xt = x
    ln = torch.nn.functional.layer_norm
    for i in range(LAYERS):
        h = ln(xt, (EMB,), tm.ln_scales[i], tm.ln_biases[i], tm.epsilon)
        qkv = torch.einsum("bsh,tndh->bstnd", h, tm.qkv_weights[i]) \
            + tm.qkv_biases[i]
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        lg = q @ k.transpose(-1, -2) / np.sqrt(HD)
        lg = lg.masked_fill(~torch.tril(torch.ones(s, s, dtype=torch.bool)),
                            float("-inf"))
        at = (torch.softmax(lg, -1) @ v).transpose(1, 2).reshape(b, s, EMB)
        xt = xt + at @ tm.linear_weights[i] + tm.linear_biases[i]
        h2 = ln(xt, (EMB,), tm.ffn_ln_scales[i], tm.ffn_ln_biases[i],
                tm.epsilon)
        f = torch.nn.functional.gelu(h2 @ tm.ffn1_weights[i]
                                     + tm.ffn1_biases[i], approximate="tanh")
        xt = xt + f @ tm.ffn2_weights[i] + tm.ffn2_biases[i]
    np.testing.assert_allclose(got.detach().numpy(), xt.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


B, S0, SMAX, PS = 2, 6, 16, 8


def _port_caches(kind):
    if kind == "5d":
        return [torch.zeros((2, B, NH, SMAX, HD)) for _ in range(LAYERS)]
    if kind == "slab":
        return [make_kv_slab(B, SMAX, NH, HD, device="cpu")
                for _ in range(LAYERS)]
    if kind == "paged_kv":
        return [PagedKVCache(num_pages=16, page_size=PS, batch_size=B,
                             num_kv_heads=NH, head_dim=HD,
                             max_pages_per_seq=SMAX // PS,
                             dtype=torch.float32, device="cpu")
                for _ in range(LAYERS)]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return [PagedCacheState(torch.zeros((8, PS, NH * HD)),
                            torch.zeros((8, PS, NH * HD)), None, tables,
                            torch.zeros((B,), dtype=torch.int32), PS)
            for _ in range(LAYERS)]


def _jax_caches(kind):
    if kind == "5d":
        return [jnp.zeros((2, B, NH, SMAX, HD), jnp.float32)
                for _ in range(LAYERS)]
    if kind == "slab":
        return [jnp.zeros((2, B, SMAX, NH * HD), jnp.float32)
                for _ in range(LAYERS)]
    if kind == "paged_kv":
        return [JaxPagedKV(num_pages=16, page_size=PS, batch_size=B,
                           num_kv_heads=NH, head_dim=HD,
                           max_pages_per_seq=SMAX // PS, dtype=jnp.float32)
                for _ in range(LAYERS)]
    tables = jnp.asarray([[1, 2], [3, 4]], jnp.int32)
    return [JaxState(jnp.zeros((8, PS, NH * HD), jnp.float32),
                     jnp.zeros((8, PS, NH * HD), jnp.float32), None, tables,
                     jnp.zeros((B,), jnp.int32), PS)
            for _ in range(LAYERS)]


KINDS = ["5d", "slab", "paged_kv", "paged_state"]


def _generate(m, caches, x, tok, steps, run):
    """Context phase on ``x`` then ``steps`` decode steps, each fed the
    previous output: the outputs in order."""
    y, caches = run(m, x, caches=caches)
    outs = [y]
    for t in range(S0, S0 + steps):
        tok, caches = run(m, tok, caches=caches, time_step=t)
        outs.append(tok)
    return outs


def _run_port(m, x, **kw):
    y, c = m(torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray)
             else x, **kw)
    return y, c


def _run_jax(m, x, **kw):
    y, c = m(Tensor._wrap(jnp.asarray(x)) if isinstance(x, np.ndarray)
             else x, **kw)
    return y, c


@pytest.mark.parametrize("kind", KINDS)
def test_fmt_cache_kinds_match_jax(fmt, kind):
    """Context phase, then three decode steps fed their own outputs, over
    each cache kind: the port against the JAX layer on the same kind (#14
    on 5-D caches, #15 on the slab, #4 on ``PagedKVCache``, #1 on
    ``PagedCacheState``: their plain twins here)."""
    jm, tm = fmt
    x, tok = _x(4, (B, S0, EMB)), _x(5, (B, 1, EMB))
    want = _generate(jm, _jax_caches(kind), x, tok, 3, _run_jax)
    got = _generate(tm, _port_caches(kind), x, tok, 3, _run_port)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), _jnp(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{kind} output {i}")


def test_fmt_cache_kinds_agree(fmt):
    """Every cache kind gives the same outputs as the 5-D cache (the
    reference's paged-equals-contiguous check, over all four kinds)."""
    _, tm = fmt
    x, tok = _x(6, (B, S0, EMB)), _x(7, (B, 1, EMB))
    runs = {kind: _generate(tm, _port_caches(kind), x, tok, 4, _run_port)
            for kind in KINDS}
    for kind in KINDS[1:]:
        for i, (g, w) in enumerate(zip(runs[kind], runs["5d"])):
            np.testing.assert_allclose(g.detach().numpy(),
                                       w.detach().numpy(), rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"{kind} output {i}")


@pytest.mark.parametrize("kind", ["5d", "slab"])
def test_fmt_cached_decode_matches_uncached(fmt, kind):
    """Context on a prompt plus one decode step a token equals the
    uncached causal forward over the whole sequence, position by
    position; the caches are written in place and returned."""
    _, tm = fmt
    prompt, new = 4, 3
    x = torch.from_numpy(_x(8, (1, prompt + new, EMB)))
    full = tm(x)
    caches = ([torch.zeros((2, 1, NH, SMAX, HD)) for _ in range(LAYERS)]
              if kind == "5d" else
              [make_kv_slab(1, SMAX, NH, HD, device="cpu")
               for _ in range(LAYERS)])
    ids = [id(c) for c in caches]
    out, caches = tm(x[:, :prompt], caches=caches)
    assert [id(c) for c in caches] == ids
    np.testing.assert_allclose(out.detach().numpy(),
                               full[:, :prompt].detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    for t in range(prompt, prompt + new):
        out, caches = tm(x[:, t:t + 1], caches=caches, time_step=t)
        np.testing.assert_allclose(out[:, 0].detach().numpy(),
                                   full[:, t].detach().numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"decode step {t}")


def test_fmt_refusals():
    # nranks must be the model-parallel group's size (one process, no
    # world: a group of one); ring_id alone on one rank is the plain layer
    with pytest.raises(ValueError, match="nranks=2"):
        FusedMultiTransformer(EMB, NH, FF, num_layers=1, nranks=2,
                              device="cpu")
    one = FusedMultiTransformer(EMB, NH, FF, num_layers=1, ring_id=0,
                                device="cpu")
    assert one.group is None and one.qkv_weights[0].shape == (3, NH, HD,
                                                              EMB)
    with pytest.raises(ValueError):
        FusedMultiTransformer(EMB, NH, FF, num_layers=1,
                              normalize_before=False, device="cpu")
    m = init_fused_multi_transformer(EMB, NH, FF, 1, seed=0, device="cpu",
                                     dtype=torch.float32)
    x = torch.zeros((1, 2, EMB))
    for kw in (dict(pre_caches=[x]), dict(rotary_embs=x),
               dict(seq_lens=x), dict(rotary_emb_dims=1),
               dict(attn_mask=torch.ones(2, 2, dtype=torch.bool),
                    caches=[torch.zeros((2, 1, NH, 4, HD))], time_step=1)):
        with pytest.raises(NotImplementedError):
            m(x, **kw)


def test_init_fused_multi_transformer_is_seeded():
    a = init_fused_multi_transformer(EMB, NH, FF, 2, seed=3, device="cpu",
                                     dtype=torch.float32)
    b = init_fused_multi_transformer(EMB, NH, FF, 2, seed=3, device="cpu",
                                     dtype=torch.float32)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert float(a.qkv_weights_1.detach().std()) == pytest.approx(0.02, rel=0.2)
    assert torch.equal(a.ln_scales_0, torch.ones(EMB))
    assert torch.equal(a.ffn2_biases_1, torch.zeros(EMB))


# ------------------------------------------ the other three fused layers
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_mha_matches_jax(pre_ln, masked):
    paddle.seed(0)
    jm = _randomize(JaxMHA(EMB, NH, normalize_before=pre_ln), 10)
    tm = _port(FusedMultiHeadAttention, jm, EMB, NH, normalize_before=pre_ln)
    x = _x(11, (2, 5, EMB))
    keep = np.ones((2, 1, 5, 5), bool)
    keep[0, :, :, 3:] = False
    jmask = jnp.asarray(keep) if masked else None
    tmask = torch.from_numpy(keep) if masked else None
    want = _jnp(jm(Tensor._wrap(jnp.asarray(x)), attn_mask=jmask))
    got = tm(torch.from_numpy(x), attn_mask=tmask).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(NotImplementedError):
        tm(torch.from_numpy(x), cache=torch.zeros(1))


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_ffn_matches_jax(act, pre_ln):
    paddle.seed(0)
    jm = _randomize(JaxFFN(EMB, FF, activation=act, normalize_before=pre_ln),
                    12)
    tm = _port(FusedFeedForward, jm, EMB, FF, activation=act,
               normalize_before=pre_ln)
    x = _x(13, (2, 5, EMB))
    want = _jnp(jm(Tensor._wrap(jnp.asarray(x))))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_encoder_layer_matches_jax(pre_ln):
    paddle.seed(0)
    jm = _randomize(JaxEnc(EMB, NH, FF, normalize_before=pre_ln), 14)
    tm = _port(FusedTransformerEncoderLayer, jm, EMB, NH, FF,
               normalize_before=pre_ln)
    x = _x(15, (2, 6, EMB))
    keep = np.tril(np.ones((6, 6), bool))[None, None]
    for jmask, tmask in ((None, None),
                         (jnp.asarray(keep), torch.from_numpy(keep))):
        want = _jnp(jm(Tensor._wrap(jnp.asarray(x)), src_mask=jmask))
        got = tm(torch.from_numpy(x), src_mask=tmask).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_fused_layers_refuse_tensor_parallel():
    """Tensor parallelism is ported (see the ``nranks=2`` tests below); an
    ``nranks`` that the model-parallel group does not have is refused, and
    ``ring_id`` on a group of one rank is the plain layer."""
    with pytest.raises(ValueError, match="nranks=2"):
        FusedMultiHeadAttention(EMB, NH, nranks=2, device="cpu")
    with pytest.raises(ValueError, match="nranks=2"):
        FusedFeedForward(EMB, FF, nranks=2, device="cpu")
    ffn = FusedFeedForward(EMB, FF, ring_id=1, device="cpu")
    assert ffn.group is None and ffn.linear1_weight.shape == (EMB, FF)


def test_dropout_draws_from_the_generator():
    """Training-mode dropout: the same generator seed gives the same
    output, another seed another; eval mode is deterministic."""
    paddle.seed(0)
    jm = _randomize(JaxEnc(EMB, NH, FF), 16)
    x = torch.from_numpy(_x(17, (2, 6, EMB)))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        tm = _port(FusedTransformerEncoderLayer, jm, EMB, NH, FF,
                   generator=gen)
        tm.train()
        return tm(x)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


# ------------------------------------------------------ the fused ops
def _args(seed):
    r = np.random.default_rng(seed)

    def a(*shape, base=0.0, s=0.3):
        return (base + s * r.standard_normal(shape)).astype(np.float32)

    return a


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*[Tensor._wrap(jnp.asarray(a)) if a is not None else None
                  for a in arrays], **kw)
    got = fn_t(*[torch.from_numpy(a) if a is not None else None
                 for a in arrays], **kw)
    np.testing.assert_allclose(got.detach().numpy(), _jnp(want), **TOL)


@pytest.mark.parametrize("pre_ln,act", [(False, "relu"), (True, "gelu")])
def test_fused_feedforward_op(pre_ln, act):
    a = _args(20)
    arrays = [a(2, 5, EMB), a(EMB, FF), a(FF, EMB), a(FF), a(EMB),
              a(EMB, base=1.0), a(EMB), a(EMB, base=1.0), a(EMB)]
    _both(JIF.fused_feedforward, IF.fused_feedforward, arrays,
          dropout1_rate=0.0, dropout2_rate=0.0, activation=act,
          pre_layer_norm=pre_ln, training=False)


@pytest.mark.parametrize("pre_ln,masked", [(False, False), (True, True)])
def test_fused_multi_head_attention_op(pre_ln, masked):
    a = _args(21)
    x, qkv_w, lin_w = a(2, 5, EMB), a(3, NH, HD, EMB), a(EMB, EMB)
    qkv_b, lin_b = a(3, NH, HD), a(EMB)
    pre_s, pre_b, ln_s, ln_b = a(EMB, base=1.0), a(EMB), a(EMB, base=1.0), \
        a(EMB)
    keep = np.tril(np.ones((5, 5), bool))[None, None]

    def call(mod, wrap, mask):
        return mod.fused_multi_head_attention(
            wrap(x), wrap(qkv_w), wrap(lin_w), pre_layer_norm=pre_ln,
            pre_ln_scale=wrap(pre_s), pre_ln_bias=wrap(pre_b),
            ln_scale=wrap(ln_s), ln_bias=wrap(ln_b), qkv_bias=wrap(qkv_b),
            linear_bias=wrap(lin_b), attn_mask=mask, dropout_rate=0.0,
            attn_dropout_rate=0.0, training=False)

    want = call(JIF, lambda t: Tensor._wrap(jnp.asarray(t)),
                jnp.asarray(keep) if masked else None)
    got = call(IF, torch.from_numpy,
               torch.from_numpy(keep) if masked else None)
    np.testing.assert_allclose(got.numpy(), _jnp(want), **TOL)
    # ring_id on a group of one rank (no world) is the plain op
    plain = IF.fused_multi_head_attention(
        torch.from_numpy(x), torch.from_numpy(qkv_w),
        torch.from_numpy(lin_w), dropout_rate=0.0, attn_dropout_rate=0.0,
        training=False)
    ring = IF.fused_multi_head_attention(
        torch.from_numpy(x), torch.from_numpy(qkv_w),
        torch.from_numpy(lin_w), dropout_rate=0.0, attn_dropout_rate=0.0,
        training=False, ring_id=0)
    assert torch.equal(plain, ring)


def test_fused_softmax_masks():
    a = _args(22)
    x = a(2, 2, 4, 6, s=2.0)
    mask = np.where(np.arange(6) < 4, 0.0, -1e9).astype(
        np.float32)[None, None, None, :]
    want = JIF.fused_softmax_mask(Tensor._wrap(jnp.asarray(x)),
                                  jnp.asarray(mask), scale=0.5)
    got = IF.fused_softmax_mask(torch.from_numpy(x), torch.from_numpy(mask),
                                scale=0.5)
    np.testing.assert_allclose(got.numpy(), _jnp(want), atol=1e-6)
    want = JIF.fused_softmax_mask_upper_triangle(Tensor._wrap(jnp.asarray(x)))
    got = IF.fused_softmax_mask_upper_triangle(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _jnp(want), atol=1e-6)


def test_fused_dropout_add():
    a = _args(23)
    x, y = a(4, 8), a(4, 8)
    _both(JIF.fused_dropout_add, IF.fused_dropout_add, [x, y], p=0.5,
          training=False)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    out = IF.fused_dropout_add(tx, ty, p=0.5, seed=7)
    again = IF.fused_dropout_add(tx, ty, p=0.5,
                                 generator=torch.Generator().manual_seed(7))
    assert torch.equal(out, again)
    kept = out != ty
    np.testing.assert_allclose(out[kept].numpy(),
                               (2 * tx + ty)[kept].numpy(), rtol=1e-6)


@pytest.mark.parametrize("act,tx,ty", [("gelu", False, False),
                                       ("relu", True, False),
                                       ("none", False, True),
                                       (None, True, True)])
def test_fused_linear_activation(act, tx, ty):
    a = _args(24)
    x = a(8, 4) if tx else a(4, 8)
    w = a(6, 8) if ty else a(8, 6)
    _both(JIF.fused_linear_activation, IF.fused_linear_activation,
          [x, w, a(6)], trans_x=tx, trans_y=ty, activation=act)
    assert IF.fused_gemm_epilogue is IF.fused_linear_activation
    with pytest.raises(ValueError):
        IF.fused_linear_activation(torch.zeros(2, 2), torch.zeros(2, 2),
                                   activation="tanh")


def test_fused_bias_dropout_residual_layer_norm():
    a = _args(25)
    arrays = [a(2, 8), a(2, 8), a(8), a(8, base=1.0), a(8)]
    _both(JIF.fused_bias_dropout_residual_layer_norm,
          IF.fused_bias_dropout_residual_layer_norm, arrays,
          dropout_rate=0.0, training=False)


# -------------------------------------------- F.scaled_dot_product_attention
@pytest.mark.parametrize("mask,causal", [(None, False), (None, True),
                                         ("bool", False), ("float", True)])
def test_scaled_dot_product_attention(mask, causal):
    a = _args(26)
    q, k, v = a(2, 6, 3, 8, s=1.0), a(2, 6, 3, 8, s=1.0), a(2, 6, 3, 8)
    jm = tm = None
    if mask == "bool":
        keep = np.random.default_rng(27).random((2, 1, 6, 6)) < 0.7
        keep[..., 0] = True
        jm, tm = jnp.asarray(keep), torch.from_numpy(keep)
    elif mask == "float":
        add = (np.random.default_rng(28).standard_normal((1, 3, 6, 6))
               .astype(np.float32))
        jm, tm = jnp.asarray(add), torch.from_numpy(add)
    want = JF.scaled_dot_product_attention(
        *(Tensor._wrap(jnp.asarray(t)) for t in (q, k, v)), attn_mask=jm,
        is_causal=causal, training=False)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), attn_mask=tm,
        is_causal=causal, training=False)
    np.testing.assert_allclose(got.numpy(), _jnp(want), **TOL)


# ---------------------------------------------- tensor parallelism, nranks=2
# Two gloo ranks (``_torch_fused_world.worker``) each build the layers at
# nranks=2 from the full weights below and keep their shard; their outputs
# are held against the reference's FULL layer on the same inputs (the
# reference shards by sharding specs, so its layer computes the full
# math). Tolerances: 2e-5, and 1e-4 after decode steps fed their own
# outputs (the split GEMMs sum in another order).
@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    import _torch_fused_world as FW
    import _torch_world as W

    paddle.seed(0)
    jm = _randomize(JaxFMT(EMB, NH, FF, num_layers=LAYERS), 21)
    mha = _randomize(JaxMHA(EMB, NH, normalize_before=True), 22)
    ffn = _randomize(JaxFFN(EMB, FF, activation="gelu",
                            normalize_before=True), 23)
    arrays = {}
    for name in _LISTS:
        for i, p in enumerate(getattr(jm, name)):
            arrays[f"fmt.{name}.{i}"] = _jnp(p)
    for tag, layer in (("mha", mha), ("ffn", ffn)):
        for k, v in param_arrays(layer).items():
            arrays[f"{tag}.{k}"] = np.asarray(v)
    tmp = tmp_path_factory.mktemp("fused_tp")
    np.savez(tmp / "arrays.npz", **arrays)
    ranks = W.run_world(FW.worker, 2, tmp, str(tmp / "arrays.npz"))
    return dict(jm=jm, mha=mha, ffn=ffn, ranks=ranks)


def _tp_want(tp_world, case):
    import _torch_fused_world as FW

    jm = tp_world["jm"]
    if case == "fmt_none":
        return [_jnp(_jax_run(jm, FW.x_of(2, (2, 8, EMB))))]
    if case.startswith("fmt_"):
        kind = case[4:]
        x, tok = FW.x_of(4, (B, S0, EMB)), FW.x_of(5, (B, 1, EMB))
        return [_jnp(w) for w in _generate(jm, _jax_caches(kind), x, tok, 3,
                                           _run_jax)]
    xm = Tensor._wrap(jnp.asarray(FW.x_of(11, (2, 5, EMB))))
    layer = tp_world["mha" if case.startswith("mha") else "ffn"]
    return [_jnp(layer(xm))]


TP_CASES = ["fmt_none"] + [f"fmt_{k}" for k in KINDS] + [
    "mha", "ffn", "mha_op", "ffn_op"]


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_matches_reference_full_layer(tp_world, case):
    """nranks=2 (``ring_id=0`` for the ops): every rank's output equals the
    reference's full layer (the 5-D, slab, PagedKVCache and
    PagedCacheState caches holding each rank's two heads); the two ranks'
    outputs are equal bit for bit (one all-reduce result)."""
    r0, r1 = (r[case] for r in tp_world["ranks"])
    want = _tp_want(tp_world, case)
    tol = 1e-4 if case.startswith("fmt_") and case != "fmt_none" else 2e-5
    assert len(r0) == len(r1) == len(want), \
        (f"{case}: output counts rank 0 {len(r0)}, rank 1 {len(r1)}, "
         f"reference {len(want)}")
    for i, (g, w) in enumerate(zip(r0, want)):
        err = float(np.max(np.abs(np.asarray(g, np.float64) - w)))
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=tol,
            err_msg=f"{case} output {i}: the tolerance check against the "
                    f"reference's full layer (rtol = atol = {tol}) failed; "
                    f"largest abs error {err:.3g}")
    for i, (a, b) in enumerate(zip(r0, r1)):
        err = float(np.max(np.abs(np.asarray(a, np.float64) - b)))
        np.testing.assert_array_equal(
            a, b, err_msg=f"{case} output {i}: the bitwise rank check "
                          f"failed; largest difference between the ranks "
                          f"{err:.3g}")


def test_tensor_parallel_shards_concatenate_to_full(tp_world):
    """The shard step (``convert.fused_multi_transformer_from_numpy(...,
    nranks=2)``): each split parameter's two shards, concatenated along its
    split dim, are the reference's parameter; the whole ones are equal."""
    from paddle_tpu_torch.incubate.nn.layer.fused_transformer import \
        _MP_SPECS

    jm = tp_world["jm"]
    s0, s1 = (r["fmt_shards"] for r in tp_world["ranks"])
    for name in _LISTS:
        for i, p in enumerate(getattr(jm, name)):
            key = f"{name}_{i}"
            spec = _MP_SPECS.get(name)
            want = _jnp(p)
            if spec is None:
                for r, got in ((0, s0[key]), (1, s1[key])):
                    np.testing.assert_array_equal(
                        got, want, err_msg=_shard_msg(key, f"rank {r}'s "
                                                      f"whole copy", got,
                                                      want))
                continue
            dim = spec.index("mp")
            got = np.concatenate([s0[key], s1[key]], axis=dim)
            np.testing.assert_array_equal(
                got, want, err_msg=_shard_msg(key, "the two shards, "
                                              "concatenated", got, want))


def _shard_msg(key, what, got, want):
    if np.shape(got) != np.shape(want):
        return (f"{key}: the bitwise shard check failed: {what} has shape "
                f"{np.shape(got)}, the reference {np.shape(want)}")
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    return (f"{key}: the bitwise shard check failed: {what} against the "
            f"reference's parameter, largest difference {err:.3g}")
