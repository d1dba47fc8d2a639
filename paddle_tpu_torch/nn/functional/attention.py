"""Attention functions, after ``paddle_tpu/nn/functional/attention.py``.

``flash_attention`` routes to the hand-written CUDA flash kernels for CUDA
tensors and to their plain versions for CPU tensors, through their
registered operators (so ``torch.compile`` and ``torch.export`` trace it).
The operator is the forward kernel with its log-sum-exp; when autograd
needs gradients its backward runs the backward kernel. Without gradients
(the engine's prefill, ``torch.no_grad``) a traced call (``torch.compile``,
``torch.export``) keeps the operator's output, and an eager call runs the
forward wrapper directly: the operator's dispatch costs the host ~60 µs a
call (``chip_smoke.py`` kernels phase, H100 80GB HBM3, 700.00 W). Unlike
the JAX package's ``_pallas_ok`` gate there is no shape gate: the kernels
mask ragged sequence edges themselves, and the forward takes head dims 16,
32, 64, 128 and 256 (the backward 64, 128 and 256).
``FLAGS_use_flash_attention
= False`` sends it to ``naive_attention``, as in the reference.

``scaled_dot_product_attention`` without a mask is ``flash_attention``
(kernel #2); with one it is the reference's masked softmax, which runs
outside any kernel there too: plain PyTorch here, a boolean mask (True
keeps) becoming ``-inf`` on the logits it drops.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...framework.flags import get_flags
from ...ops.cuda.flash_attention import (flash_attention_fused,
                                         flash_attention_fwd,
                                         flash_attention_fwd_lse_op)
from .common import dropout as _dropout

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "naive_attention"]


def naive_attention(q, k, v, causal=False, scale=None, bias=None):
    """Reference attention on ``[B, S, H, D]`` (equal head counts): f32
    logits and softmax, probabilities cast to the input dtype. ``bias``
    (broadcastable to ``[B, H, Sq, Sk]``) is added to the f32 logits.
    Causality is bottom-right aligned, as in the JAX ``naive_attention``."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() * s
    if bias is not None:
        logits = logits + bias
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(qt.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, generator=None):
    """Inputs ``[batch, seq, num_heads, head_dim]``. Returns ``(out,
    None)`` like the reference API, or ``(out, probs)`` with
    ``return_softmax``: the attention probabilities ``[batch, num_heads,
    seq_q, seq_k]`` in f32, computed in plain PyTorch beside the kernel's
    output as the reference does (no kernel materialises them).
    ``dropout`` applies to the output, outside the kernel, when
    ``training``, with its mask from ``generator``."""
    q, k, v = amp_cast("attention", query, key, value)
    if not get_flags("FLAGS_use_flash_attention")["FLAGS_use_flash_attention"]:
        out = naive_attention(q, k, v, causal=causal)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = flash_attention_fused(q, k, v, causal=causal)
    elif torch.compiler.is_compiling():  # traced: the operator's node
        out = flash_attention_fwd_lse_op(q, k, v, bool(causal), None, None,
                                         None)[0]
    else:  # eager: the wrapper, without the operator's dispatch
        out = flash_attention_fwd(q, k, v, causal=causal)
    if dropout > 0.0 and training:
        out = _dropout(out, p=dropout, training=True, generator=generator)
    if return_softmax:
        return out, _softmax_probs(query, key, causal)
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention on ``[B, S, H, D]``. Without ``attn_mask``:
    ``flash_attention`` (the kernel). With one, broadcastable to ``[B, H,
    Sq, Sk]``: a float mask is added to the f32 logits, a boolean one keeps
    where True and puts ``-inf`` elsewhere, and the masked softmax runs in
    plain PyTorch, as the reference's runs in ``jnp``. ``dropout_p``
    applies to the output when ``training``, its mask from
    ``generator``."""
    if attn_mask is None:
        out, _ = flash_attention(query, key, value, dropout=dropout_p,
                                 causal=is_causal, training=training,
                                 generator=generator)
        return out
    q, k, v = amp_cast("attention", query, key, value)
    mask = torch.as_tensor(attn_mask, device=q.device)
    if mask.dtype == torch.bool:
        bias = torch.zeros(mask.shape, dtype=torch.float32,
                           device=q.device).masked_fill(~mask,
                                                        float("-inf"))
    else:
        bias = mask.float()
    out = naive_attention(q, k, v, causal=is_causal, bias=bias)
    if dropout_p > 0.0 and training:
        out = _dropout(out, p=dropout_p, training=True, generator=generator)
    return out


def _softmax_probs(q, k, causal):
    """The reference's ``_softmax_probs``: q.k^T over sqrt(head_dim) in the
    inputs' dtype, then f32, the causal mask a lower triangle over the key
    length, softmax over the keys."""
    d = q.shape[-1]
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() / (d ** 0.5)
    if causal:
        s = logits.shape[-1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits,
                             torch.full_like(logits, float("-inf")))
    return torch.softmax(logits, dim=-1)
