"""Fused functional ops, after ``paddle_tpu/incubate/nn/functional``.

``masked_multihead_attention`` runs the decode kernel #14;
``fused_multi_head_attention`` runs the flash forward (#2) or, with a
mask, ``F.scaled_dot_product_attention``'s masked softmax;
``ring_flash_attention`` the context-parallel ring. The other fused ops
reach no kernel of their own in the reference either (each is one XLA
fusion there): here they are the same arithmetic in PyTorch. Dropout
masks come from an explicit ``generator`` (a ``torch.Generator`` on the
input's device; the default generator when None).

``ring_id >= 0`` is tensor parallelism over the model-parallel group
(``fleet``'s, else the world): the weights passed are this rank's shards
(``qkv_weight`` its ``num_heads/mp`` heads, ``linear_weight`` their rows;
``linear1_weight`` its ``dim_feedforward/mp`` columns, ``linear2_weight``
their rows), and the sum of the ranks' partial products is all-reduced
after the output projection and after linear2, before the bias and the
residual.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...ops.cuda.decode_attention import decode_attention

__all__ = ["fused_rotary_position_embedding", "masked_multihead_attention",
           "ring_flash_attention", "fused_feedforward",
           "fused_multi_head_attention", "fused_softmax_mask",
           "fused_softmax_mask_upper_triangle", "fused_dropout_add",
           "fused_linear_activation", "fused_gemm_epilogue",
           "fused_bias_dropout_residual_layer_norm"]


def ring_group(ring_id: int):
    """The group of a fused op's ``ring_id``: None (no tensor parallelism)
    below 0, else the model-parallel group."""
    if ring_id < 0:
        return None
    from ...distributed.fleet.meta_parallel.mp_layers import mp_group_of

    return mp_group_of(None)


def mp_reduce(t, group):
    """The all-reduce of a row-parallel GEMM's partial products over
    ``group`` (identity for None or one rank)."""
    if group is None or group.nranks <= 1:
        return t
    from ...distributed.fleet.meta_parallel.mp_layers import reduce_from_mp

    return reduce_from_mp(t, group)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, name=None,
                      generator=None):
    """The functional ``FusedFeedForward``: (pre-LN), linear1, the
    activation, dropout, linear2 (all-reduced at ``ring_id >= 0``),
    dropout, the residual, (post-LN)."""
    from .layer.fused_transformer import _act

    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, [d], ln1_scale, ln1_bias, ln1_epsilon)
    h = torch.matmul(x, linear1_weight)
    if linear1_bias is not None:
        h = h + linear1_bias
    h = F.dropout(_act(activation)(h), p=dropout1_rate, training=training,
                  mode=mode, generator=generator)
    h = mp_reduce(torch.matmul(h, linear2_weight), ring_group(ring_id))
    if linear2_bias is not None:
        h = h + linear2_bias
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode,
                  generator=generator)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, [d], ln2_scale, ln2_bias, ln2_epsilon)
    return out


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, name=None,
                               generator=None):
    """The functional ``FusedMultiHeadAttention``; ``qkv_weight`` is
    ``[3, num_heads, head_dim, embed_dim]`` (this rank's heads at
    ``ring_id >= 0``)."""
    from .layer.fused_transformer import _qkv_pack

    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention: cache_kv (incremental decode) is "
            "not supported here — use masked_multihead_attention or "
            "FusedMultiTransformer's cache path; silently dropping it would "
            "compute non-cached attention and a stale cache")
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, [d], pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    b, s, _ = x.shape
    q, k, v = _qkv_pack(x, qkv_weight, qkv_bias).unbind(dim=2)
    if attn_mask is not None:
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
            training=training, generator=generator)
    else:
        out, _ = F.flash_attention(q, k, v, dropout=attn_dropout_rate,
                                   causal=False, training=training,
                                   generator=generator)
    out = mp_reduce(torch.matmul(out.reshape(b, s, linear_weight.shape[0]),
                                 linear_weight), ring_group(ring_id))
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode,
                    generator=generator)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [d], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_softmax_mask(x, mask, scale=1.0):
    """``softmax(scale * x + mask)`` over the last dim, in f32, cast back
    to x's dtype."""
    m = torch.as_tensor(mask, device=x.device)
    return torch.softmax(x.float() * scale + m, dim=-1).to(x.dtype)


def fused_softmax_mask_upper_triangle(x):
    """The causal softmax: the last dim's softmax with the strict upper
    triangle (bottom-right aligned) masked out, in f32."""
    sq, sk = x.shape[-2], x.shape[-1]
    keep = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                 device=x.device), diagonal=sk - sq)
    s = x.float().masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1).to(x.dtype)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      seed=None, name=None, generator=None):
    """``dropout(x) + y``. Without a ``generator``, a ``seed`` seeds one on
    x's device."""
    if generator is None and seed is not None:
        generator = torch.Generator(device=x.device).manual_seed(int(seed))
    return F.dropout(x, p=p, training=training, mode=mode,
                     generator=generator) + y


def fused_linear_activation(x, weight, bias=None, trans_x=False,
                            trans_y=False, activation="gelu"):
    """The GEMM with its bias and activation epilogue (cuBLASLt's
    ``fused_gemm_epilogue`` in the reference's source):
    ``act(x @ weight + bias)``, each operand's last two dims swapped by
    ``trans_x`` / ``trans_y``; ``activation`` in gelu (tanh form), relu,
    ``"none"`` or None."""
    acts = {"gelu": lambda a: F.gelu(a, approximate=True), "relu": F.relu,
            "none": lambda a: a, None: lambda a: a}
    if activation not in acts:
        raise ValueError(
            f"fused_linear_activation: unsupported activation "
            f"{activation!r}; choose from {sorted(k for k in acts if k)}")
    xa = x.transpose(-1, -2) if trans_x else x
    wa = weight.transpose(-1, -2) if trans_y else weight
    out = torch.matmul(xa, wa)
    if bias is not None:
        out = out + bias
    return acts[activation](out)


fused_gemm_epilogue = fused_linear_activation  # the reference op's name


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None, generator=None):
    """``layer_norm(dropout(x + bias) + residual)``."""
    h = x if bias is None else x + bias
    h = F.dropout(h, p=dropout_rate, training=training, mode=mode,
                  generator=generator) + residual
    return F.layer_norm(h, [h.shape[-1]], ln_scale, ln_bias, ln_epsilon)


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
