"""Transformer layers, after ``paddle_tpu/nn/transformer.py``:
``MultiHeadAttention`` (with its ``Cache`` / ``StaticCache``),
``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``.

Parameter names and layouts are the reference's (``self_attn.q_proj.
weight`` ``[in, out]``, ``linear1``, ``norm1``, ``layers.0...``), so a JAX
state dict loads with no renaming or transposes. Weights are drawn on
``device`` with the reference's defaults, as the port's ``Linear`` draws
them; a loaded state dict or the model's initialiser replaces them.

Attention without a mask runs ``F.scaled_dot_product_attention`` →
``F.flash_attention``: kernel #2 on the card (non-causal; with autograd,
the backward kernel #5/#6). With ``attn_mask`` it is the reference's
masked softmax in plain PyTorch, as the reference's runs in ``jnp``. The
dropout layers and the attention dropout draw their masks from
``generator`` (a ``torch.Generator`` on the activations' device; the
default generator when None).

A ``Cache`` from ``gen_cache`` starts with zero keys in the key's dtype
and device (the reference's is always f32) and grows by concatenation; a
``StaticCache`` holds the projected keys and values of a fixed memory.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ..framework.device import resolve_device
from . import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        kw = dict(bias_attr=bias_attr, device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        """``[B, S, E]`` -> ``[B, S, H, D]``."""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        k = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)  # the reference returns no weights either
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _layer_parts(layer, d_model, dim_feedforward, dropout, activation,
                 act_dropout, normalize_before, bias_attr, layer_norm_eps,
                 norms, device, dtype, generator):
    """The parts both layer kinds share: the feed-forward block, ``norms``
    LayerNorms and as many residual dropouts."""
    layer.normalize_before = normalize_before
    layer.linear1 = Linear(d_model, dim_feedforward, bias_attr=bias_attr,
                           device=device, dtype=dtype)
    layer.dropout = Dropout(act_dropout, generator=generator)
    layer.linear2 = Linear(dim_feedforward, d_model, bias_attr=bias_attr,
                           device=device, dtype=dtype)
    for i in range(1, norms + 1):
        setattr(layer, f"norm{i}", LayerNorm(d_model, epsilon=layer_norm_eps,
                                             device=device, dtype=dtype))
    for i in range(1, norms + 1):
        setattr(layer, f"dropout{i}", Dropout(dropout, generator=generator))
    layer.activation = getattr(F, activation)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, bias_attr=bias_attr,
            device=device, dtype=dtype, generator=generator)
        _layer_parts(self, d_model, dim_feedforward, dropout, activation,
                     act_dropout, normalize_before, bias_attr,
                     layer_norm_eps, 2, device, dtype, generator)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, attn_mask=src_mask)
        else:
            src, cache = self.self_attn(src, src, src, attn_mask=src_mask,
                                        cache=cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, as in the reference), then the optional ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(dropout=attn_dropout, bias_attr=bias_attr, device=device,
                  dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, **kw)
        _layer_parts(self, d_model, dim_feedforward, dropout, activation,
                     act_dropout, normalize_before, bias_attr,
                     layer_norm_eps, 3, device, dtype, generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt,
                                             attn_mask=tgt_mask,
                                             cache=cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask,
                                  cache=cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask=tgt_mask,
                                        memory_mask=memory_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=device, dtype=dtype, generator=generator)

        def final_norm():
            return (LayerNorm(d_model, device=device, dtype=dtype)
                    if normalize_before else None)

        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                final_norm())
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` f32: 0 on and below the diagonal, ``-inf``
        above, on ``device`` (the card unless the caller names the
        CPU)."""
        return torch.triu(torch.full((length, length), float("-inf"),
                                     device=resolve_device(device)),
                          diagonal=1)
