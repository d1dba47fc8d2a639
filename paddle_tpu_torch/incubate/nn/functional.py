"""Fused functional ops, after ``paddle_tpu/incubate/nn/functional``."""
from __future__ import annotations

import torch

__all__ = ["fused_rotary_position_embedding"]


def fused_rotary_position_embedding(q, k=None, v=None, position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """Rotary embedding on q/k[/v] ``[batch, seq, heads, head_dim]``. The
    frequencies are computed AT ``position_ids`` ([batch, seq]; default
    ``arange(seq)``), so decode steps rotate at their true positions. The
    sin/cos tables are cast to each input's dtype before use, as in the
    reference. Returns ``(q, k, v)`` with None passed through."""
    b, s, _, d = q.shape
    dev = q.device
    inv = 1.0 / (rotary_emb_base ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
    if position_ids is not None:
        freqs = position_ids.float()[..., None] * inv   # [b, s, d/2]
    else:
        freqs = torch.outer(torch.arange(s, dtype=torch.float32,
                                         device=dev), inv)[None]
    if use_neox_rotary_style:
        emb = torch.cat([freqs, freqs], dim=-1)
    else:
        emb = torch.repeat_interleave(freqs, 2, dim=-1)
    sin_a, cos_a = torch.sin(emb)[:, :, None], torch.cos(emb)[:, :, None]

    def rotate(x):
        if use_neox_rotary_style:
            x1, x2 = x[..., : d // 2], x[..., d // 2:]
            return torch.cat([-x2, x1], dim=-1)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([-x2, x1], dim=-1).reshape(x.shape)

    def ap(x):
        return x * cos_a.to(x.dtype) + rotate(x) * sin_a.to(x.dtype)

    return tuple(None if t is None else ap(t) for t in (q, k, v))
