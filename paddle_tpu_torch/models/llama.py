"""LLaMA decoder (RMSNorm, neox rotary embeddings at per-slot positions,
grouped-query attention, SwiGLU), dense path, after
``paddle_tpu/models/llama.py``.

Parameter names match the JAX package's ``state_dict`` names one for one
(``model.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, ...), and
``Linear`` weights keep the ``[in, out]`` layout, so weights cross over
with no renaming or transposes (``convert.state_dict_from_numpy``).

``forward(input_ids, caches=None)`` runs the cacheless path (prefill-style
causal attention over the whole input) or, with one ``PagedCacheState`` per
layer, the serving path: an admission prefill (context attention through
the flash kernel, the prompt written to the pages) or one decode token per
slot (the paged decode kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..framework.device import resolve_device, resolve_dtype
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..nn import functional as F
from ..ops.cuda.paged_attention import PagedCacheState, paged_forward

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama2_7b",
           "tiny_llama_config"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32  # < num_heads → grouped-query attention
    intermediate_size: int = 11008
    max_position: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self, include_embeddings=True):
        h, l = self.hidden_size, self.num_layers
        kvh = self.num_kv_heads * self.head_dim
        mlp = 3 * h * self.intermediate_size
        n = l * (h * h + 2 * h * kvh + h * h + mlp)
        if include_embeddings:
            n += 2 * self.vocab_size * h
        return n


def llama2_7b():
    return LlamaConfig()


def tiny_llama_config(**kw):
    base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=128, max_position=128)
    base.update(kw)
    return LlamaConfig(**base)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = hd
        self.rope_theta = config.rope_theta
        kw = dict(device=device, dtype=dtype)
        self.q_proj = pnn.Linear(h, config.num_heads * hd, **kw)
        self.k_proj = pnn.Linear(h, config.num_kv_heads * hd, **kw)
        self.v_proj = pnn.Linear(h, config.num_kv_heads * hd, **kw)
        self.o_proj = pnn.Linear(config.num_heads * hd, h, **kw)

    def _rope(self, q, k, cache=None):
        # per-slot positions: a ragged serving batch rotates each slot at
        # its own length
        pos = (cache.positions(q.shape[1])
               if isinstance(cache, PagedCacheState) else None)
        q, k, _ = fused_rotary_position_embedding(
            q, k, position_ids=pos, rotary_emb_base=self.rope_theta)
        return q, k

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k = self._rope(q, k, cache)
        group = nh // nkv

        def expand_kv(t):
            return t if group == 1 else t.repeat_interleave(group, dim=2)

        def context():
            return F.flash_attention(q, expand_kv(k), expand_kv(v),
                                     causal=True)[0]

        new_cache = None
        if cache is None:
            out = context()
        else:
            out, new_cache = paged_forward(cache, q, k, v, context)
        out = self.o_proj(out.reshape(b, s, nh * hd))
        if cache is not None:
            return out, new_cache
        return out


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = pnn.Linear(h, m, **kw)
        self.up_proj = pnn.Linear(h, m, **kw)
        self.down_proj = pnn.Linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = pnn.RMSNorm(config.hidden_size,
                                           epsilon=config.rms_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = pnn.RMSNorm(
            config.hidden_size, epsilon=config.rms_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cache=None):
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x))
            return x + self.mlp(self.post_attention_layernorm(x))
        attn, new_cache = self.self_attn(self.input_layernorm(x),
                                         cache=cache)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class LlamaModel(nn.Module):
    """Trunk: embedding, decoder stack, final RMSNorm."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = pnn.Embedding(config.vocab_size,
                                          config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            [LlamaBlock(config, **kw) for _ in range(config.num_layers)])
        self.norm = pnn.RMSNorm(config.hidden_size, epsilon=config.rms_eps,
                                **kw)

    def forward(self, input_ids, caches=None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for block in self.layers:
                x = block(x)
            return self.norm(x)
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, nc = block(x, cache=cache)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Untied LM head (llama convention). Built on ``device`` (CUDA unless
    ``device="cpu"``) in ``dtype``; the weights are uninitialised until
    ``convert.init_llama`` or ``load_state_dict`` fills them."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.config = config
        self.model = LlamaModel(config, device=dev, dtype=dt)
        self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                  device=dev, dtype=dt)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    def forward(self, input_ids, caches=None):
        if caches is None:
            return self.lm_head(self.model(input_ids))
        x, new_caches = self.model(input_ids, caches=caches)
        return self.lm_head(x), new_caches
