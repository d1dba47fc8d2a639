"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of the forward of ``paddle_tpu/ops/pallas/flash_attention.py``
``flash_attention_fused`` (TPU kernel ``_fwd_kernel``). The CUDA source is
``paddle_tpu_torch/csrc/flash_attention_fwd.cu``.

Layout ``[B, S, H, D]`` in and out (the paddle flash_attention layout); the
kernel reads these strides directly, so no ``[B*H, S, D]`` copy is made.
Causality is top-left aligned (query i sees keys j <= i), as in the Pallas
kernel. k/v may carry fewer heads than q (GQA: q head h reads kv head
``h // (H // Hkv)``).

A CPU tensor takes :func:`flash_attention_ref`; a CUDA tensor launches the
kernel or raises. ``flash_attention_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_fwd", "flash_attention_ref"]

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_ref(q, k, v, causal=True, scale=None, return_lse=False):
    """Plain PyTorch twin of the kernel: f32 logits and softmax, P rounded
    to the input dtype before the P.V product (f32 accumulation), rows with
    no key give zeros. Returns ``out [B, Sq, H, D]`` in q's dtype, plus
    ``lse [B, H, Sq]`` f32 when ``return_lse``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    pr = p.to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", pr, v.float()) / \
        l.permute(0, 2, 1, 3)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({k.shape[2]})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must live on one device")


def flash_attention_fwd(q, k, v, causal=True, scale=None,
                        return_lse=False):
    """Flash attention forward on ``[B, S, H, D]`` tensors. Returns ``out``
    (and ``lse [B, H, Sq]`` f32 when ``return_lse``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel grid")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    from ...kernels import build

    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = (
        torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if return_lse else None)
    lib = build.load("flash_attention_fwd")
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, hkv, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), float(scale), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q.device))
    build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
