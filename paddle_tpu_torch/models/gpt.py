"""GPT decoder-only transformer, after ``paddle_tpu/models/gpt.py``: pre-LN
blocks with a packed QKV projection (one ``[H, 3H]`` GEMM), GELU MLP, LM
head tied to the token embedding.

Parameter names match the JAX package's (``gpt.wte.weight``,
``gpt.h.0.attn.qkv_proj.weight``, ...) and ``Linear`` weights keep the
``[in, out]`` layout, so weights cross over with no renaming or
transposes (``convert.gpt_from_numpy``).

Attention takes one of two routes in training, as in the reference:

* **packed** (``GPTAttention._packed_ok``): the QKV projection's output is
  viewed as ``[B, 3H/hpb, S, hpb*D]`` and handed to ``causal_flash_qkv``,
  whose output view ``[B, H/hpb, S, hpb*D]`` folds back into the output
  projection's input. Every layout change is a view: the kernels read and
  write the projections' own buffers through strides.
* **general**: q, k, v unbound from the projection and run through
  ``F.flash_attention`` (its autograd Function on the card).

``FLAGS_use_packed_attention`` picks the route: None (the default) means
packed when the activations are on CUDA.

With caches (one per layer) the attention takes the reference's cache
branches: a contiguous cache from ``init_caches`` (the slab) or a
user-allocated ``[2, B, H, S, D]`` one is written by a prefill
(``time_step`` None; the context attention runs ``F.flash_attention``) or
by one decode token at ``time_step`` (``cache_decode_step``: kernels #15
and #14); a ``PagedKVCache`` or ``PagedCacheState`` goes through
``paged_forward``. ``GenerationMixin.generate`` drives the contiguous
caches.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..framework.device import resolve_device, resolve_dtype
from ..framework.flags import get_flags
from ..nn import functional as F
from ..ops.cuda import causal_flash
from ..ops.cuda.decode_attention import (cache_decode_step,
                                         cache_prefill_write, make_kv_slab)
from ..ops.cuda.paged_attention import (PagedCacheState, PagedKVCache,
                                        paged_forward)
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small",
           "gpt2_medium", "gpt3_6p7b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    intermediate_size: int = 0  # 0 -> 4*hidden
    hidden_dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash: bool = True

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self, include_embeddings=True):
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        n = l * (4 * h * h + 2 * h * self.intermediate_size)
        if include_embeddings:
            n += v * h + self.max_position * h
        return n


def gpt2_small():
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)


def gpt2_medium():
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16)


def gpt3_6p7b():
    return GPTConfig(vocab_size=50304, hidden_size=4096, num_layers=32,
                     num_heads=32, max_position=2048)


def _check_caches(caches, num_layers):
    if len(caches) != num_layers or any(c is None for c in caches):
        raise TypeError(f"caches: one cache per layer ({num_layers}), "
                        "none of them None")


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.use_flash = config.use_flash
        self.attn_dropout = config.attn_dropout
        self.generator = generator
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = pnn.Linear(h, 3 * h, **kw)
        self.out_proj = pnn.Linear(h, h, **kw)

    def _packed_ok(self, x):
        """Train-path packed kernel eligibility (see causal_flash.py)."""
        flag = get_flags("FLAGS_use_packed_attention")[
            "FLAGS_use_packed_attention"]
        if flag is None:
            flag = x.device.type == "cuda"
        return (bool(flag) and self.use_flash and self.attn_dropout == 0.0
                and causal_flash.supported(x.shape[1], self.head_dim))

    def _forward_packed(self, x):
        """The QKV projection's ``[B, S, 3H*D]`` output viewed as ``[B,
        3H/hpb, S, hpb*D]`` for the packed kernel, and its ``[B, H/hpb, S,
        hpb*D]`` output viewed back as ``[B, S, H*D]``: no copy on either
        side. Weights are cast to the activations' dtype, as the
        reference's einsum does."""
        b, s, hid = x.shape
        nh, hd = self.num_heads, self.head_dim
        hpb = causal_flash.heads_per_block(nh, hd)
        lanes = hpb * hd
        wq, bq = self.qkv_proj.weight, self.qkv_proj.bias
        wo, bo = self.out_proj.weight, self.out_proj.bias
        y = torch.matmul(x, wq.to(x.dtype)) + bq.to(x.dtype)
        qkv = y.view(b, s, 3 * nh // hpb, lanes).transpose(1, 2)
        o = causal_flash.causal_flash_qkv(qkv, nh, hd)
        o = o.transpose(1, 2).reshape(b, s, hid)
        return torch.matmul(o, wo.to(x.dtype)) + bo.to(x.dtype)

    def forward(self, x, cache=None, time_step=None):
        """Without a cache: the packed or the general training route.
        With one: returns ``(out, new_cache)`` (see the module doc)."""
        if cache is None and self._packed_ok(x):
            return self._forward_packed(x)
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is None:
            out, _ = F.flash_attention(q, k, v, dropout=self.attn_dropout,
                                       causal=True, training=self.training,
                                       generator=self.generator)
            return self.out_proj(out.reshape(b, s, h))

        def context():
            return F.flash_attention(q, k, v, causal=True,
                                     training=False)[0]

        if isinstance(cache, (PagedKVCache, PagedCacheState)):
            out, new_cache = paged_forward(cache, q, k, v, context,
                                           time_step=time_step)
        elif time_step is None:
            new_cache = cache_prefill_write(cache, k, v)
            out = context()
        else:
            out, new_cache = cache_decode_step(cache, q, k, v, time_step)
        return self.out_proj(out.reshape(b, s, h)), new_cache


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc = pnn.Linear(config.hidden_size, config.intermediate_size,
                             **kw)
        self.proj = pnn.Linear(config.intermediate_size, config.hidden_size,
                               **kw)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        eps = config.layer_norm_eps
        self.ln_1 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, generator=generator, **kw)
        self.ln_2 = pnn.LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout, generator=generator)

    def forward(self, x, cache=None, time_step=None):
        if cache is None:
            x = x + self.dropout(self.attn(self.ln_1(x)))
            return x + self.dropout(self.mlp(self.ln_2(x)))
        attn, new_cache = self.attn(self.ln_1(x), cache=cache,
                                    time_step=time_step)
        x = x + attn
        return x + self.mlp(self.ln_2(x)), new_cache


class GPTModel(nn.Module):
    """Trunk: embeddings + decoder stack + final LN."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_position, config.hidden_size,
                                 **kw)
        self.drop = pnn.Dropout(config.hidden_dropout, generator=generator)
        self.h = nn.ModuleList([GPTBlock(config, generator=generator, **kw)
                                for _ in range(config.num_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps, **kw)

    def forward(self, input_ids, caches=None, time_step=None):
        """Positions ``arange(s) + time_step`` (per slot for a
        ``PagedCacheState``: slot b at its own length). Returns the final
        hidden states, and the new caches when ``caches`` is given."""
        s = input_ids.shape[1]
        if caches and isinstance(caches[0], PagedCacheState):
            pos = caches[0].positions(s)
        else:
            pos = torch.arange(s, device=input_ids.device)[None, :]
            if time_step is not None:
                pos = pos + time_step
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        _check_caches(caches, len(self.h))
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, nc = block(x, cache=cache, time_step=time_step)
            new_caches.append(nc)
        return self.ln_f(x), new_caches

    def init_caches(self, batch_size, max_seq, dtype=torch.float32):
        """Zeroed slab caches ``[2, batch_size, max_seq, H*D]``, one per
        layer, on the model's device (the reference's layout for
        ``cache_decode_step``)."""
        cfg = self.config
        return [make_kv_slab(batch_size, max_seq, cfg.num_heads,
                             cfg.head_dim, dtype, self.wte.weight.device)
                for _ in range(cfg.num_layers)]


class GPTForCausalLM(GenerationMixin, nn.Module):
    """LM head tied to ``wte``: logits = trunk(x) @ wte.weight^T. Built on
    ``device`` (CUDA unless ``device="cpu"``) in ``dtype``, each layer's
    weights drawn with the reference's defaults (``convert.init_gpt`` or
    ``load_state_dict`` replaces them). ``generator`` (on ``device``) draws the dropout masks.
    Generation over the KV caches comes from ``GenerationMixin``."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device=resolve_device(device),
                            dtype=resolve_dtype(dtype), generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def forward(self, input_ids, caches=None, time_step=None):
        if caches is None:
            return self._logits(self.gpt(input_ids, time_step=time_step))
        x, new_caches = self.gpt(input_ids, caches=caches,
                                 time_step=time_step)
        return self._logits(x), new_caches

    def _logits(self, x):
        return torch.matmul(x, self.gpt.wte.weight.to(x.dtype).t())

    def init_caches(self, batch_size, max_seq, dtype=torch.float32):
        return self.gpt.init_caches(batch_size, max_seq, dtype)

    def loss(self, input_ids, labels):
        """Mean causal-LM loss over every position (an ``ignore_index``
        label counts as 0), the reference's off-mesh
        ``ParallelCrossEntropy``."""
        logits = self.forward(input_ids)
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  labels.reshape(-1), reduction="none")
        return per_tok.mean()
