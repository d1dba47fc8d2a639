"""The port's flash attention (plain version, which CPU tensors take)
against paddle_tpu's ``flash_attention_fused`` in Pallas interpret mode and
against ``naive_attention``: causal and not, sequence lengths that are no
multiple of 8, GQA through the LLaMA ``expand_kv`` repeat and natively.
f32 throughout; atol 2e-5 (online vs direct softmax, summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    naive_attention as jax_naive
from paddle_tpu.ops.pallas.flash_attention import flash_attention_fused

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                       flash_attention_ref)
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-5


def _qkv(rng, b, s, h, d, hkv=None):
    hkv = hkv or h
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [16, 13])
def test_matches_pallas_interpret(causal, s, rng):
    q, k, v = _qkv(rng, 2, s, 2, 16)
    want = np.asarray(flash_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 7, 29])
def test_matches_naive(causal, s, rng):
    q, k, v = _qkv(rng, 1, s, 3, 8)
    want = np.asarray(jax_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    got, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the port's own naive twin agrees as well
    np.testing.assert_allclose(
        TF.naive_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
        want, atol=ATOL, rtol=0)


def test_gqa_expand_kv_matches(rng):
    """GQA as LLaMA runs it: kv heads repeated (``jnp.repeat`` on the head
    axis) before the kernel; the port's kernel also takes the narrow k/v
    natively (q head h reads kv head h // group)."""
    q, k, v = _qkv(rng, 2, 11, 4, 16, hkv=2)
    kx, vx = (np.repeat(a, 2, axis=2) for a in (k, v))
    want = np.asarray(flash_attention_fused(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), causal=True))
    expanded = flash_attention_fwd(_t(q), _t(k).repeat_interleave(2, 2),
                                   _t(v).repeat_interleave(2, 2))
    native = flash_attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(expanded.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(native.numpy(), want, atol=ATOL, rtol=0)


def test_lse_matches_logsumexp(rng):
    q, k, v = _qkv(rng, 1, 10, 2, 8)
    _, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                 return_lse=True)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    s = np.where(np.tril(np.ones((10, 10), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_bf16_inputs_keep_dtype(rng):
    q, k, v = _qkv(rng, 1, 9, 2, 16)
    got = flash_attention_fwd(_t(q).bfloat16(), _t(k).bfloat16(),
                              _t(v).bfloat16())
    assert got.dtype == torch.bfloat16
    ref = flash_attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=3e-2,
                               rtol=3e-2)


def test_rejects_bad_operands(rng):
    q, k, v = _qkv(rng, 1, 4, 3, 8, hkv=2)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(_t(q), _t(k), _t(v))
    q, k, v = _qkv(rng, 1, 4, 2, 8)
    with pytest.raises(TypeError):
        flash_attention_fwd(_t(q), _t(k).double(), _t(v))
    with pytest.raises(ValueError):
        flash_attention_fwd(_t(q)[0], _t(k), _t(v))
