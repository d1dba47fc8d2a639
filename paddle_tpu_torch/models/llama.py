"""LLaMA decoder (RMSNorm, neox rotary embeddings at per-slot positions,
grouped-query attention, SwiGLU, or top-k routed experts), after
``paddle_tpu/models/llama.py``.

Parameter names match the JAX package's ``state_dict`` names one for one
(``model.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, ...), and
``Linear`` weights keep the ``[in, out]`` layout, so weights cross over
with no renaming or transposes (``convert.state_dict_from_numpy``).

``forward(input_ids, caches=None, time_step=None)`` runs the cacheless
path (prefill-style causal attention over the whole input) or, with one
cache per layer:

* a ``PagedCacheState`` (the engine): an admission prefill (context
  attention through the flash kernel, the prompt written to the pages) or
  one decode token per slot (the paged decode kernel #1), rotated at each
  slot's own position;
* a contiguous cache (the slab of ``init_caches``, or ``[2, B, Hkv, S,
  D]``): a prefill (``time_step`` None) or one decode token at
  ``time_step`` through ``cache_decode_step`` (kernels #15 and #14), RoPE
  at ``arange(s) + time_step``. ``GenerationMixin.generate`` drives it;
* a host-managed ``PagedKVCache`` through ``paged_forward`` (kernel #4).

GQA stays native on every decode path: no repeat of K/V.

With ``num_experts > 0`` every block's MLP is ``LlamaMoEMLP``: GShard-style
top-k routing with a static per-expert capacity (overflow pairs drop and
the combine renormalises) and the experts' SwiGLU through the grouped
matmul kernel #13, on one device (the reference's expert-parallel
``all_to_all`` / ``all_gather`` path is not ported).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..framework.device import resolve_device, resolve_dtype
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..nn import functional as F
from ..nn.layer import make_parameter
from ..ops.cuda.decode_attention import (cache_decode_step,
                                         cache_prefill_write, make_kv_slab)
from ..ops.cuda.grouped_matmul import grouped_matmul
from ..ops.cuda.paged_attention import (PagedCacheState, PagedKVCache,
                                        paged_forward)
from .generation import GenerationMixin
from .gpt import _check_caches

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama2_7b",
           "tiny_llama_config", "tiny_moe_llama_config", "LlamaMoEMLP",
           "moe_stats_tap", "moe_stats_size"]


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
    # MoE: num_experts > 0 swaps every block's MLP for LlamaMoEMLP.
    # moe_intermediate_size is the per-expert FF width (0 → the dense
    # intermediate_size); capacity_factor sizes the static per-expert token
    # budget C = ceil(cf * top_k * T / E), past which pairs drop
    num_experts: int = 0
    moe_top_k: int = 2
    moe_intermediate_size: int = 0
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.num_experts:
            if not 0 < self.moe_top_k <= self.num_experts:
                raise ValueError("moe_top_k must be in [1, num_experts]")
            if not self.moe_intermediate_size:
                self.moe_intermediate_size = self.intermediate_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self, include_embeddings=True):
        h, l = self.hidden_size, self.num_layers
        kvh = self.num_kv_heads * self.head_dim
        if self.num_experts:
            mlp = (self.num_experts * 3 * h * self.moe_intermediate_size
                   + h * self.num_experts)             # experts + router
        else:
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


def tiny_moe_llama_config(**kw):
    """Tiny MoE twin of ``tiny_llama_config``: 8 experts, top-2, 64-wide
    expert FFs (active FF width per token 2 * 64, the dense config's 128)."""
    base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=128, max_position=128,
                num_experts=8, moe_top_k=2, moe_intermediate_size=64)
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
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.q_proj = pnn.Linear(h, config.num_heads * hd, **kw)
        self.k_proj = pnn.Linear(h, config.num_kv_heads * hd, **kw)
        self.v_proj = pnn.Linear(h, config.num_kv_heads * hd, **kw)
        self.o_proj = pnn.Linear(config.num_heads * hd, h, **kw)

    def _rope(self, q, k, time_step=None, cache=None):
        b, s = q.shape[:2]
        if isinstance(cache, PagedCacheState):
            # per-slot positions: a ragged serving batch rotates each slot
            # at its own length
            pos = cache.positions(s)
        elif time_step is None:
            pos = None
        else:
            pos = (torch.arange(s, device=q.device)[None]
                   + time_step).expand(b, s)
        q, k, _ = fused_rotary_position_embedding(
            q, k, position_ids=pos, rotary_emb_base=self.rope_theta)
        return q, k

    def forward(self, x, cache=None, time_step=None):
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k = self._rope(q, k, time_step, cache)
        group = nh // nkv

        def expand_kv(t):
            return t if group == 1 else t.repeat_interleave(group, dim=2)

        def context():
            # training runs the flash backward, which takes as many k/v
            # heads as q heads: GQA heads are repeated first, as the
            # reference does
            return F.flash_attention(q, expand_kv(k), expand_kv(v),
                                     causal=True, training=self.training)[0]

        new_cache = None
        if cache is None:
            out = context()
        elif isinstance(cache, (PagedKVCache, PagedCacheState)):
            out, new_cache = paged_forward(cache, q, k, v, context,
                                           time_step=time_step)
        elif time_step is None:
            new_cache = cache_prefill_write(cache, k, v)
            out = context()
        else:
            # the decode kernels read kv head h // group natively
            out, new_cache = cache_decode_step(cache, q, k, v, time_step)
        out = self.o_proj(out.reshape(b, s, nh * hd))
        if cache is not None:
            return out, new_cache
        return out


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.gate_proj = pnn.Linear(h, m, **kw)
        self.up_proj = pnn.Linear(h, m, **kw)
        self.down_proj = pnn.Linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


# Router-stats side channel: the engine arms the tap around each forward of
# an MoE model; every MoE layer then appends one [E+3] f32 device vector
# (per-expert kept pairs, dropped pairs, router-entropy sum, routed
# tokens). Unarmed, the layers compute no stats. Process-global: safe while
# one thread runs the engine's forwards (the serving front end's engine
# thread); two threads forwarding MoE models at once would share the tap.
_MOE_STATS_TAP = None


@contextlib.contextmanager
def moe_stats_tap():
    """Collect the per-MoE-layer routing stats of the forwards run under
    this context. Yields the list the layers append to."""
    global _MOE_STATS_TAP
    prev = _MOE_STATS_TAP
    _MOE_STATS_TAP = tap = []
    try:
        yield tap
    finally:
        _MOE_STATS_TAP = prev


def moe_stats_size(config) -> int:
    """Length of the MoE stats vector (0 for dense models): [0:E] kept
    pairs per expert, [E] dropped pairs, [E+1] router-entropy sum, [E+2]
    routed tokens."""
    e = getattr(config, "num_experts", 0) or 0
    return e + 3 if e else 0


class LlamaMoEMLP(nn.Module):
    """Top-k routed expert FFN: a ``router`` Linear ``[H, E]`` and stacked
    expert weights ``experts_gate/up [E, H, F]``, ``experts_down [E, F,
    H]`` (the ``ragged_dot`` rhs orientation), bias-free. Serving only:
    see :func:`_moe_forward`."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, f = config.hidden_size, config.moe_intermediate_size
        e = config.num_experts
        self.num_experts = e
        self.top_k = config.moe_top_k
        self.capacity_factor = float(config.capacity_factor)
        kw = dict(device=device, dtype=dtype)
        self.router = pnn.Linear(h, e, bias_attr=False, **kw)
        init = pnn.initializer.Normal(std=config.initializer_range)
        self.experts_gate = make_parameter((e, h, f), **kw,
                                           default_initializer=init)
        self.experts_up = make_parameter((e, h, f), **kw,
                                         default_initializer=init)
        self.experts_down = make_parameter((e, f, h), **kw,
                                           default_initializer=init)

    def forward(self, x):
        return _moe_forward(self, x)


def _top_k(p, k):
    """``jax.lax.top_k`` over the last dim: values descending, the lower
    index first on ties (``torch.argmax`` returns the first maximum)."""
    vals, idx = [], []
    work = p
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(p, -1, i))
        idx.append(i)
        work = work.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _moe_forward(m: LlamaMoEMLP, x):
    """The reference's ``_moe_forward`` at ep=1: routing (f32 softmax,
    top-k, arrival ranks in gshard column-major pair order, capacity
    keep/drop), dispatch into a capacity-padded ``[E*C, H]`` buffer by a
    scatter-add with a dump row for dropped pairs, the experts' SwiGLU as
    three grouped matmuls over C-row segments (kept counts as valid sizes,
    so capacity padding is skipped and comes back zero), and the combine
    renormalised over kept choices, summed in f32 in choice order. No step
    waits for the device."""
    b, s, hd = x.shape
    e, k = m.num_experts, m.top_k
    t = b * s
    xt = x.reshape(t, hd)
    dev = x.device

    # ---- routing ------------------------------------------------------
    logits = torch.matmul(xt.float(), m.router.weight.float())    # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_val, gate_idx = _top_k(probs, k)                          # [T, k]
    cap = max(1, int(math.ceil(m.capacity_factor * k * t / e)))
    one = (gate_idx[..., None] == torch.arange(e, device=dev)).to(
        torch.int32)                                               # [T,k,E]
    # arrival rank: all choice-0 pairs in token order, then choice-1, ...
    oc = one.transpose(0, 1).reshape(k * t, e)
    rank = ((torch.cumsum(oc, dim=0) * oc).sum(-1) - 1).reshape(
        k, t).transpose(0, 1)                                      # [T, k]
    keep = rank < cap
    tot = oc.sum(0)                                                # [E]
    kc = torch.clamp(tot, max=cap).to(torch.int32)  # kept per expert

    # ---- dispatch: capacity-padded [E, C, H], slots by rank ----------
    gslot = gate_idx * cap + torch.clamp(rank, 0, cap - 1)
    slot = torch.where(keep, gslot, torch.full_like(gslot, e * cap))
    xp = xt[:, None, :].expand(t, k, hd).reshape(t * k, hd)
    disp = torch.zeros((e * cap + 1, hd), dtype=xt.dtype, device=dev)
    disp.index_add_(0, slot.reshape(-1), xp)
    rows = disp[:e * cap]

    # ---- grouped expert SwiGLU over contiguous C-row segments ---------
    gs = torch.full((e,), cap, dtype=torch.int32, device=dev)
    dt = rows.dtype
    h1 = grouped_matmul(rows, m.experts_gate.to(dt), gs, kc)
    h2 = grouped_matmul(rows, m.experts_up.to(dt), gs, kc)
    y_all = grouped_matmul(F.silu(h1) * h2, m.experts_down.to(dt), gs, kc)

    # ---- combine: renormalised over kept choices, f32, choice order ---
    wk = torch.where(keep, gate_val, torch.zeros_like(gate_val))
    den = wk.sum(-1, keepdim=True)
    wc = torch.where(den > 0, wk / den, torch.zeros_like(wk))      # [T, k]
    out = torch.zeros((t, hd), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + wc[:, j:j + 1] * y_all[gslot[:, j]].float()

    if _MOE_STATS_TAP is not None:
        ent = -torch.sum(probs * torch.log(probs + 1e-20), dim=-1)
        _MOE_STATS_TAP.append(torch.cat([
            kc.float(), (tot - kc).sum().float()[None], ent.sum()[None],
            torch.full((1,), float(t), device=dev)]))
    return out.to(x.dtype).reshape(b, s, hd)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = pnn.RMSNorm(config.hidden_size,
                                           epsilon=config.rms_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = pnn.RMSNorm(
            config.hidden_size, epsilon=config.rms_eps, **kw)
        self.mlp = (LlamaMoEMLP(config, **kw) if config.num_experts
                    else LlamaMLP(config, **kw))

    def forward(self, x, cache=None, time_step=None):
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x))
            return x + self.mlp(self.post_attention_layernorm(x))
        attn, new_cache = self.self_attn(self.input_layernorm(x),
                                         cache=cache, time_step=time_step)
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

    def forward(self, input_ids, caches=None, time_step=None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for block in self.layers:
                x = block(x)
            return self.norm(x)
        _check_caches(caches, len(self.layers))
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, nc = block(x, cache=cache, time_step=time_step)
            new_caches.append(nc)
        return self.norm(x), new_caches

    def init_caches(self, batch_size, max_seq, dtype=torch.float32):
        """Zeroed slab caches ``[2, batch_size, max_seq, Hkv*D]`` (GQA-narrow),
        one per layer, on the model's device."""
        cfg = self.config
        return [make_kv_slab(batch_size, max_seq, cfg.num_kv_heads,
                             cfg.head_dim, dtype,
                             self.embed_tokens.weight.device)
                for _ in range(cfg.num_layers)]


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Untied LM head (llama convention). Built on ``device`` (CUDA unless
    ``device="cpu"``) in ``dtype``, each layer's weights drawn with the
    reference's defaults (``convert.init_llama`` or ``load_state_dict``
    replaces them). Generation
    over the KV caches comes from ``GenerationMixin``."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.config = config
        self.model = LlamaModel(config, device=dev, dtype=dt)
        self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, device=dev, dtype=dt)

    # the embedding is never quantized (``nn.quant.quantize_for_decode``
    # swaps every Linear, lm_head included), so it carries the model's
    # device and activation dtype
    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def forward(self, input_ids, caches=None, time_step=None):
        if caches is None:
            return self.lm_head(self.model(input_ids))
        x, new_caches = self.model(input_ids, caches=caches,
                                   time_step=time_step)
        return self.lm_head(x), new_caches

    def init_caches(self, batch_size, max_seq, dtype=torch.float32):
        return self.model.init_caches(batch_size, max_seq, dtype)

    def loss(self, input_ids, labels):
        """Mean causal-LM loss over every position (an ``ignore_index``
        label counts as 0), the reference's off-mesh
        ``ParallelCrossEntropy``. Dense models only: the reference's LLaMA
        MoE block runs its expert dispatch off the autograd tape (train
        dense, serve MoE); MoE training is ``incubate.distributed.models.
        moe.MoELayer``."""
        if self.config.num_experts:
            raise TypeError("LlamaForCausalLM.loss: the LLaMA MoE block is "
                            "serving-only, as the reference's (its expert "
                            "dispatch is not on the autograd tape: train "
                            "dense, serve MoE); train MoE through "
                            "incubate.distributed.models.moe.MoELayer")
        logits = self.forward(input_ids)
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  labels.reshape(-1), reduction="none")
        return per_tok.mean()
