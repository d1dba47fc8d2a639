"""Attention functions, after ``paddle_tpu/nn/functional/attention.py``.

``flash_attention`` routes to the hand-written CUDA flash kernel for CUDA
tensors and to the kernel's plain version for CPU tensors. Unlike the JAX
package's ``_pallas_ok`` gate there is no shape gate: the kernel masks
ragged sequence edges itself.
"""
from __future__ import annotations

import torch

from ...ops.cuda.flash_attention import flash_attention_fwd

__all__ = ["flash_attention", "naive_attention"]


def naive_attention(q, k, v, causal=False, scale=None):
    """Reference attention on ``[B, S, H, D]`` (equal head counts): f32
    logits and softmax, probabilities cast to the input dtype. Causality
    is bottom-right aligned, as in the JAX ``naive_attention``."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(qt.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def flash_attention(query, key, value, causal=False):
    """Inputs ``[batch, seq, num_heads, head_dim]``. Returns ``(out, None)``
    like the reference API (the second slot is the softmax the reference
    can return on request; the port never materialises it)."""
    return flash_attention_fwd(query, key, value, causal=causal), None
