"""Fused functional ops, after ``paddle_tpu/incubate/nn/functional``."""
from __future__ import annotations

import torch

from ...ops.cuda.decode_attention import decode_attention

__all__ = ["fused_rotary_position_embedding", "masked_multihead_attention",
           "ring_flash_attention"]


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


def masked_multihead_attention(x, cache_kv=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Single-token decode attention against a KV cache (the reference's
    ``masked_multihead_attention``).

    ``x`` is the current token's packed qkv [B, 3*H*D]; ``cache_kv`` is
    [2, B, H, S, D]; ``sequence_lengths`` [B] gives each element's current
    length: the new token's k/v are written at that row and kernel #14
    attends over ``sequence_lengths + 1`` rows. Returns ``(out [B, H*D],
    cache_kv)``. Unlike the reference's functional update, ``cache_kv`` is
    written IN PLACE: the returned cache is the tensor passed in."""
    unsupported = {
        "src_mask": src_mask, "cum_offsets": cum_offsets,
        "rotary_tensor": rotary_tensor, "beam_cache_offset": beam_cache_offset,
        "qkv_out_scale": qkv_out_scale, "out_shift": out_shift,
        "out_smooth": out_smooth,
    }
    bad = [k for k, v in unsupported.items() if v is not None]
    if rotary_emb_dims:
        bad.append("rotary_emb_dims")
    if out_scale != -1:
        bad.append("out_scale")
    if bad:
        raise NotImplementedError(
            f"masked_multihead_attention: unsupported arguments {bad} "
            "(rotary/quant variants are not implemented — silently dropping "
            "them would compute wrong attention)")

    _, bsz, nh, _, hd = cache_kv.shape
    qkv = x.reshape(bsz, 3, nh, hd)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [b, nh, hd]
    if sequence_lengths is None:
        raise ValueError("masked_multihead_attention requires sequence_lengths")
    lens = sequence_lengths.reshape(-1).to(device=cache_kv.device,
                                           dtype=torch.long)
    # the new token at row lens[b] of each batch element
    rows = torch.arange(bsz, device=cache_kv.device)
    cache_kv[0][rows, :, lens] = k.to(cache_kv.dtype)
    cache_kv[1][rows, :, lens] = v.to(cache_kv.dtype)
    out = decode_attention(q, cache_kv[0], cache_kv[1],
                           (lens + 1).to(torch.int32))
    return out.reshape(bsz, nh * hd), cache_kv


def ring_flash_attention(q, k, v, causal=True, axis_name="sep", **kw):
    """PaddleNLP's ``ring_flash_attention`` name for the context-parallel
    ring (``fleet.meta_parallel.ring_attention``) on this rank's
    ``[B, S/W, H, D]`` shards, differentiable through the flash kernels."""
    from ...distributed.fleet.meta_parallel.context_parallel import (
        ring_attention_op)

    return ring_attention_op(q, k, v, causal=causal, axis_name=axis_name,
                             **kw)
