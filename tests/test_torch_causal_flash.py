"""The port's ``causal_flash_qkv`` (packed-QKV causal attention; CPU
tensors take the flash kernels' plain twins) against paddle_tpu's, whose
Pallas kernels run in interpret mode: the forward and the gradient of
``sum(out * ct)`` with respect to the packed tensor, per-head (hpb = 1)
and pair-packed (hpb = 2, two D = 64 heads in 128 lanes) layouts, at the
shapes ``tests/test_causal_flash_packed.py`` runs: S = 256 (#7 forward,
#11 backward), S = 1024 (#9, #11) and S = 2048 (#9, #10). f32, atol 2e-5
(summation order). Also the shape predicates and the no-copy views of
the GPT route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import causal_flash as jcf

from paddle_tpu_torch.ops.cuda import causal_flash as tcf
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-5


def _case(seed, b, h, s, d, hpb):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((b, 3 * h // hpb, s, hpb * d)) * 0.3
           ).astype(np.float32)
    ct = (rng.standard_normal((b, h // hpb, s, hpb * d)) * 0.1
          ).astype(np.float32)
    return qkv, ct


@pytest.mark.parametrize("hpb", [1, 2])
@pytest.mark.parametrize("s", [256, 1024, 2048])
def test_forward_and_grad_match_pallas_interpret(s, hpb):
    b, h, d = (2 if s == 256 else 1), 2, 64
    qkv, ct = _case(s + hpb, b, h, s, d, hpb)
    hd = d if hpb == 2 else None   # the reference's two call styles
    want_o, vjp = jax.vjp(lambda x: jcf.causal_flash_qkv(x, h, hd),
                          jnp.asarray(qkv))
    (want_g,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(qkv).requires_grad_()
    out = tcf.causal_flash_qkv(x, h, hd)
    assert out.shape == want_o.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               atol=ATOL, rtol=0)


def test_head_dim_128_matches_pallas_interpret():
    qkv, ct = _case(3, 1, 2, 128, 128, 1)
    want_o, vjp = jax.vjp(lambda x: jcf.causal_flash_qkv(x, 2),
                          jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = tcf.causal_flash_qkv(x, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [8, 64, 1024, 1030, 1536, 2048, 2056, 4096,
                               8192, 16384])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_supported_matches_reference(s, d):
    assert tcf.supported(s, d) == jcf.supported(s, d)


@pytest.mark.parametrize("h,d", [(2, 64), (3, 64), (4, 128), (16, 64)])
def test_heads_per_block_matches_reference(h, d):
    assert tcf.heads_per_block(h, d) == jcf.heads_per_block(h, d)


def test_plain_reference_agrees():
    qkv, _ = _case(4, 1, 4, 64, 64, 2)
    x = torch.from_numpy(qkv)
    torch.testing.assert_close(tcf.causal_flash_qkv(x, 4, 64),
                               tcf.causal_flash_qkv_ref(x, 4, 64),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("hpb", [1, 2])
def test_gpt_route_views_make_no_copy(hpb):
    """The GPT route hands the kernel a view of the QKV projection's
    ``[B, S, 3H*D]`` output; the output and the gradient come back as
    views of ``[B, S, H, D]`` / ``[B, S, 3H, D]`` buffers, which fold into
    the projections' layouts with no copy. Values equal the contiguous
    packed layout's."""
    b, s, h, d = 2, 32, 4, 64
    rng = np.random.default_rng(hpb)
    y = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)
                                             ).astype(np.float32) * 0.3)
    y.requires_grad_()
    lanes = hpb * d
    qkv = y.view(b, s, 3 * h // hpb, lanes).transpose(1, 2)
    out = tcf.causal_flash_qkv(qkv, h, d)
    flat = out.transpose(1, 2).reshape(b, s, h * d)
    assert flat._base is not None  # a view, not a copy
    ct = torch.from_numpy(rng.standard_normal(flat.shape).astype(np.float32))
    flat.backward(ct)
    assert y.grad.shape == y.shape and y.grad.is_contiguous()
    x2 = qkv.detach().contiguous().requires_grad_()
    out2 = tcf.causal_flash_qkv(x2, h, d)
    torch.testing.assert_close(out2, out.detach(), atol=0, rtol=0)
    out2.backward(ct.view(b, s, h // hpb, lanes).transpose(1, 2))
    torch.testing.assert_close(
        x2.grad.transpose(1, 2).reshape(b, s, 3 * h * d), y.grad, atol=0,
        rtol=0)


def test_rejects_unsupported_shapes():
    with pytest.raises(ValueError, match="inconsistent"):
        tcf.causal_flash_qkv(torch.zeros((1, 5, 16, 64)), 2)
    with pytest.raises(ValueError, match="unsupported"):
        tcf.causal_flash_qkv(torch.zeros((1, 6, 1030, 64)), 2)
