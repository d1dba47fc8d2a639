"""The port's flash backward (plain twin ``flash_attention_bwd_ref`` and the
differentiable forward operator ``flash_attention_fwd_lse``, whose
registered backward CPU tensors run through the twins) against
``jax.grad`` of paddle_tpu's ``flash_attention_fused`` /
``flash_attention_with_lse``, whose Pallas kernels run in interpret mode:

* square S <= 1024, causal and not: the fused whole-sequence backward (#5);
* sq != sk (top-left causality) and S > 1024: the split dK/dV and dQ
  kernels (#6);
* sk = 100 (no multiple of 8): the kv padding the reference adds and masks;
* bf16 operands;
* ``flash_attention_with_lse`` with an lse cotangent (folded into delta).

f32 tolerance atol 2e-5: the twin forms P from the lse where the kernels
tile, so sums run in another order. bf16: atol 2e-2 on values of order 1
(P and dS rounded to bf16 in both, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-5


def _inputs(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    ctl = rng.standard_normal((b, h, sq)).astype(np.float32)
    return q, k, v, ct, ctl


def _jax_grads(q, k, v, ct, causal, dtype=jnp.float32, ctl=None):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    if ctl is None:
        def f(a, b, c):
            out = jfa.flash_attention_fused(a, b, c, causal=causal)
            return jnp.sum(out.astype(jnp.float32) * ct)
    else:
        def f(a, b, c):
            out, lse = jfa.flash_attention_with_lse(a, b, c, causal=causal)
            return (jnp.sum(out.astype(jnp.float32) * ct)
                    + jnp.sum(lse * ctl))
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, ct, causal, dtype=torch.float32, ctl=None):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    if ctl is None:
        out = fa.flash_attention_fused(*ts, causal=causal)
        loss = (out.float() * torch.from_numpy(ct)).sum()
    else:
        out, lse = fa.flash_attention_with_lse(*ts, causal=causal)
        loss = ((out.float() * torch.from_numpy(ct)).sum()
                + (lse * torch.from_numpy(ctl)).sum())
    loss.backward()
    return [t.grad.float().numpy() for t in ts]


def _twin_grads(q, k, v, ct, causal, ctl=None):
    """The plain twin called directly on the forward twin's out and lse."""
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal=causal,
                                      return_lse=True)
    dlse = None if ctl is None else torch.from_numpy(ctl)
    return [g.numpy() for g in fa.flash_attention_bwd_ref(
        tq, tk, tv, out, tct, lse, dlse, causal=causal)]


def _close(got, want, atol, tag):
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{tag}: d{name}")


# (b, sq, sk, h, d): which reference kernel the shape reaches
SHAPES = {
    "square S=128 (#5)": (2, 128, 128, 2, 64),
    "square S=1024 (#5 at its limit)": (1, 1024, 1024, 1, 64),
    "square S=1100 (#6)": (1, 1100, 1100, 1, 64),
    "sq=64 < sk=128 (#6)": (1, 64, 128, 2, 64),
    "sq=128 > sk=64 (#6)": (1, 128, 64, 2, 64),
    "sk=100 unaligned (#5, kv padding)": (1, 100, 100, 2, 64),
    "sq=64, sk=100 (#6, kv padding)": (1, 64, 100, 2, 64),
    "D=128": (1, 96, 96, 2, 128),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_grads_match_pallas_interpret(shape, causal):
    b, sq, sk, h, d = shape
    q, k, v, ct, _ = _inputs(sq + sk + d, b, sq, sk, h, d)
    want = _jax_grads(q, k, v, ct, causal)
    _close(_port_grads(q, k, v, ct, causal), want, ATOL, "Function")
    _close(_twin_grads(q, k, v, ct, causal), want, ATOL, "twin")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 100)])
def test_lse_cotangent_matches_pallas_interpret(sq, sk, causal):
    q, k, v, ct, ctl = _inputs(7 + sq, 1, sq, sk, 2, 64)
    want = _jax_grads(q, k, v, ct, causal, ctl=ctl)
    _close(_port_grads(q, k, v, ct, causal, ctl=ctl), want, ATOL,
           "Function with dlse")
    _close(_twin_grads(q, k, v, ct, causal, ctl=ctl), want, ATOL,
           "twin with dlse")


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_grads_match_pallas_interpret(causal):
    q, k, v, ct, _ = _inputs(11, 1, 64, 64, 2, 64)
    want = _jax_grads(q, k, v, ct, causal, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, ct, causal, dtype=torch.bfloat16)
    _close(got, want, 2e-2 * max(1.0, max(np.abs(w).max() for w in want)),
           "bf16")


def test_lse_forward_matches_pallas_interpret():
    q, k, v, _, _ = _inputs(3, 1, 40, 100, 2, 64)
    want_o, want_l = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out, lse = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=0)


def test_bwd_writes_preallocated_strided_grads():
    """``grads=`` views into one packed buffer receive the same values the
    default allocation gets (how the packed route fills dQKV in place)."""
    q, k, v, ct, _ = _inputs(5, 2, 32, 32, 2, 64)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, return_lse=True)
    want = fa.flash_attention_bwd(tq, tk, tv, out, tct, lse)
    buf = torch.full((2, 32, 6, 64), float("nan"))
    got = fa.flash_attention_bwd(tq, tk, tv, out, tct, lse,
                                 grads=(buf[:, :, :2], buf[:, :, 2:4],
                                        buf[:, :, 4:]))
    for g, w in zip(got, want):
        assert g.data_ptr() >= buf.data_ptr()
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert not torch.isnan(buf).any()


def test_forward_writes_strided_out_in_place():
    q, k, v, _, _ = _inputs(6, 1, 24, 24, 2, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    buf = torch.zeros((1, 24, 3, 64))
    got = fa.flash_attention_fwd(tq, tk, tv, out=buf[:, :, 1:])
    torch.testing.assert_close(buf[:, :, 1:], fa.flash_attention_fwd(
        tq, tk, tv), atol=0, rtol=0)
    assert got.data_ptr() == buf[:, :, 1:].data_ptr()
    assert not buf[:, :, 0].any()


def test_function_rejects_gqa_and_positions():
    q, k, v, _, _ = _inputs(1, 1, 8, 8, 4, 64)
    k2 = torch.from_numpy(k[:, :, :2].copy())
    with pytest.raises(ValueError, match="heads"):
        fa.flash_attention_fused(torch.from_numpy(q), k2, k2)
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="kv_positions"):
        fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_positions=pos)
    with pytest.raises(ValueError, match="lse"):
        tq = torch.from_numpy(q)
        fa.flash_attention_bwd(tq, tq, tq, tq, tq, torch.zeros((1, 4, 7)))


def test_f_flash_attention_routes_through_the_function():
    """With autograd on, ``F.flash_attention`` differentiates through the
    Function (its gradients equal the direct Function's); without, it
    returns the forward alone."""
    q, k, v, ct, _ = _inputs(9, 1, 16, 16, 2, 64)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, none = TF.flash_attention(*ts, causal=True)
    assert none is None and out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    want = _port_grads(q, k, v, ct, True)
    _close([t.grad.numpy() for t in ts], want, 0, "F.flash_attention")
    with torch.no_grad():
        out2, _ = TF.flash_attention(*ts, causal=True)
    assert out2.grad_fn is None
    torch.testing.assert_close(out2, out.detach(), atol=0, rtol=0)


def test_f_flash_attention_dropout_and_training():
    """``dropout`` applies to the output, outside the kernel, only when
    ``training``; its mask comes from the given generator."""
    q, k, v, _, _ = _inputs(10, 1, 16, 16, 2, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain, _ = TF.flash_attention(tq, tk, tv, causal=True)
    off, _ = TF.flash_attention(tq, tk, tv, dropout=0.5, causal=True,
                                training=False)
    torch.testing.assert_close(off, plain, atol=0, rtol=0)
    outs = [TF.flash_attention(tq, tk, tv, dropout=0.5, causal=True,
                               training=True,
                               generator=torch.Generator().manual_seed(4))[0]
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    want = TF.dropout(plain, p=0.5, training=True,
                      generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(outs[0], want, atol=0, rtol=0)
    dropped = outs[0] == 0
    assert 0.3 < dropped.float().mean().item() < 0.7
    torch.testing.assert_close(outs[0][~dropped], 2 * plain[~dropped])


@pytest.mark.parametrize("causal", [True, False])
def test_f_flash_attention_return_softmax_matches_reference(causal):
    """``return_softmax=True`` gives ``(out, probs)`` as the JAX
    ``F.flash_attention`` does: the output is the kernel's (here its plain
    twin's, equal to ``return_softmax=False``), the probabilities
    [B, H, Sq, Sk] f32 from the reference's ``_softmax_probs`` rule. f32
    inputs; atol 1e-6 on probabilities in [0, 1] (einsum order)."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    q, k, v, _, _ = _inputs(11, 2, 24, 24, 3, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, probs = TF.flash_attention(tq, tk, tv, causal=causal,
                                    return_softmax=True)
    plain, _ = TF.flash_attention(tq, tk, tv, causal=causal)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)
    jout, jprobs = JF.flash_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), causal=causal,
        return_softmax=True)
    jprobs = np.asarray(jprobs.numpy())
    assert probs.dtype == torch.float32 and probs.shape == jprobs.shape
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()),
                               atol=ATOL, rtol=0)
    if causal:
        assert float(probs[..., 0, 1:].abs().max()) == 0.0
