"""Packed-QKV causal flash attention, the GPT train path's attention.

Port of ``paddle_tpu/ops/pallas/causal_flash.py`` ``causal_flash_qkv``. The
reference runs five TPU kernels: three forward regimes chosen by sequence
length (#7 ``_fwd`` whole-sequence, #8 ``_fwd_tiled`` triangle grid, #9
``_fwd_row`` whole-row) and two backward regimes (#11 ``_bwd``, the fused
``fused_bwd_math`` body, up to S = 1024; #10 ``_bwd_tiled``, the shared-p
triangle grid, above). The regimes are VMEM artifacts of the TPU; on the
card each direction is one kernel at every length:

* forward: the flash forward kernel (``csrc/flash_attention_fwd.cu``, #2's
  port) reading q, k and v as strided views of the packed tensor, with no
  slicing copies;
* backward: the flash backward kernel (``csrc/flash_attention_bwd.cu``),
  writing dQ, dK and dV straight into one packed dQKV, the layout the QKV
  projection's backward consumes.

The contract is the reference's: ``qkv [B, 3H/hpb, S, hpb*D]`` in (q head
blocks, then k, then v; ``hpb = heads_per_block(H, D)``), ``[B, H/hpb, S,
hpb*D]`` out. ``hpb = 2`` pairs D = 64 heads into the TPU's 128 lanes; the
card has no such need, and the kernels see heads, not lane blocks. When
``qkv`` is a view of the QKV projection's ``[B, S, 3H*D]`` output (what
the port's ``GPTAttention`` passes) the heads sit at one stride whatever
``hpb`` is, and nothing is copied: the output is a view of a ``[B, S, H,
D]`` buffer and the gradient a view of a ``[B, S, 3H, D]`` one, which
fold back into the projections' ``[B, S, H*D]`` layouts as views too. Any
other layout (a contiguous ``[B, 3H/2, S, 2D]`` tensor, say) is copied
once into head order in the wrapper.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bwd, flash_attention_fwd

__all__ = ["causal_flash_qkv", "heads_per_block", "supported",
           "causal_flash_qkv_ref"]

_MAX_SEQ = 1024          # the reference's whole-sequence regime
_MAX_SEQ_TILED = 8192    # ... and its tiled regime's cap
_BLK = 512


def heads_per_block(num_heads: int, head_dim: int) -> int:
    """2 when pair-packing D=64 heads into 128-lane blocks is possible (even
    head count), else 1 (the reference's rule)."""
    return 2 if (head_dim == 64 and num_heads % 2 == 0) else 1


def supported(seq: int, head_dim: int) -> bool:
    """The reference's shape contract: D in {64, 128, 256}; S % 8 == 0 up
    to 1024, else S % 512 == 0 up to 8192 (4096 at D = 256)."""
    if head_dim not in (64, 128, 256):
        return False
    if seq <= _MAX_SEQ:
        return seq % 8 == 0
    limit = _MAX_SEQ_TILED if head_dim <= 128 else _MAX_SEQ_TILED // 2
    return seq % _BLK == 0 and seq <= limit


def _heads(qkv, num_heads, head_dim):
    """``[B, S, 3H, D]`` view of the packed tensor (a copy only when the
    heads do not sit at one stride)."""
    b, _, s, _ = qkv.shape
    return qkv.transpose(1, 2).reshape(b, s, 3 * num_heads, head_dim)


class _PackedCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim, scale):
        b, groups, s, lanes = qkv.shape
        h = num_heads
        t = _heads(qkv, h, head_dim)
        q, k, v = t[:, :, :h], t[:, :, h:2 * h], t[:, :, 2 * h:]
        o = torch.empty((b, s, h, head_dim), dtype=qkv.dtype,
                        device=qkv.device)
        _, lse = flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                     return_lse=True, out=o)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (groups, lanes, scale)
        return o.view(b, s, groups // 3, lanes).transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        groups, lanes, scale = ctx.meta
        b, s, h, d = q.shape
        # an f32 cotangent (f32 loss tail) is carried at the qkv dtype, as
        # the reference's _packed_bwd_rule does
        do = do.to(q.dtype).transpose(1, 2).reshape(b, s, h, d)
        dqkv = torch.empty((b, s, 3 * h, d), dtype=q.dtype, device=q.device)
        flash_attention_bwd(q, k, v, o, do, lse, causal=True, scale=scale,
                            grads=(dqkv[:, :, :h], dqkv[:, :, h:2 * h],
                                   dqkv[:, :, 2 * h:]))
        return (dqkv.view(b, s, groups, lanes).transpose(1, 2), None, None,
                None)


def _validate(qkv, num_heads, head_dim):
    b, groups, seq, lanes = qkv.shape
    if head_dim is None:
        head_dim = lanes  # hpb == 1 call style
    hpb = lanes // head_dim
    if (lanes % head_dim or num_heads % hpb
            or groups * hpb != 3 * num_heads):
        raise ValueError(
            f"causal_flash_qkv: qkv shape {tuple(qkv.shape)} inconsistent "
            f"with num_heads={num_heads}, head_dim={head_dim}")
    if not supported(seq, head_dim):
        raise ValueError(
            f"causal_flash_qkv: unsupported shape {tuple(qkv.shape)}; need "
            f"D in (64,128,256) and S % 8 == 0 (S <= {_MAX_SEQ}) or "
            f"S % {_BLK} == 0 (S <= {_MAX_SEQ_TILED})")
    return head_dim


def causal_flash_qkv(qkv, num_heads, head_dim=None):
    """Causal self-attention on a packed QKV tensor.

    qkv: ``[B, 3H/hpb, S, hpb*D]`` (q head blocks, then k, then v). Returns
    ``[B, H/hpb, S, hpb*D]``; differentiable (gradients through the flash
    backward kernel)."""
    head_dim = _validate(qkv, num_heads, head_dim)
    scale = 1.0 / (head_dim ** 0.5)
    return _PackedCausal.apply(qkv, num_heads, head_dim, float(scale))


def causal_flash_qkv_ref(qkv, num_heads, head_dim=None):
    """Plain PyTorch attention on the packed layout (autograd through
    einsum and softmax), for checking the Function's gradients."""
    head_dim = _validate(qkv, num_heads, head_dim)
    b, groups, s, lanes = qkv.shape
    h = num_heads
    t = _heads(qkv, h, head_dim).float()
    q, k, v = t[:, :, :h], t[:, :, h:2 * h], t[:, :, 2 * h:]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / head_dim ** 0.5
    keep = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=qkv.device))
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).to(qkv.dtype)
    return o.reshape(b, s, groups // 3, lanes).transpose(1, 2)
