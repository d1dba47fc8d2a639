"""Fused transformer layers, after
``paddle_tpu/incubate/nn/layer/fused_transformer.py``:
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedMultiTransformer`` and ``FusedTransformerEncoderLayer``.

The per-layer dataflow is the reference's: pre-LN, the packed QKV GEMM
with the ``[3, num_heads, head_dim, embed_dim]`` weight layout, attention,
the output projection, the residual, LN, FFN1, the activation, FFN2, the
residual. The GEMMs and the elementwise work are PyTorch's; the attention
is the port's kernels:

* no cache: the flash forward (#2) through ``F.flash_attention``, or the
  masked softmax of ``F.scaled_dot_product_attention`` when a mask is
  given (plain PyTorch, as the reference's runs in ``jnp``);
* a ``PagedKVCache`` or ``PagedCacheState``: ``paged_forward`` (#4 on the
  host-managed cache; #1, or #3 for a verify state, on the engine's);
* a 5-D ``[2, B, H, S, D]`` cache or a slab from ``make_kv_slab``: the
  context phase (``time_step`` None) writes the prompt
  (``cache_prefill_write``) beside the context attention, the decode
  phase appends one token at ``time_step`` and attends
  (``cache_decode_step``: #14 on 5-D caches, #15 on a slab).

Caches are written IN PLACE; ``forward`` still returns them, as the
reference's functional update does. Parameters are registered under the
reference's names (``qkv_weights_0``, ...) and keep its layouts, so
weights cross over with no transposes
(``convert.fused_multi_transformer_from_numpy``). Parameters are drawn
as the reference's ``create_parameter`` draws them: weight matrices
XavierNormal (the reference's fan rule for their shape), LN scales one,
biases zero, unless the matching ``*_attr`` carries an initializer
(``convert.init_fused_multi_transformer`` redraws the matrices from a
seed). Dropout masks come from ``generator``.

Tensor parallelism (``nranks > 1`` or ``ring_id >= 0``, over the
model-parallel group: ``fleet``'s, else the world, of ``nranks`` ranks)
follows the reference's sharding specs, one process a rank: each rank
holds its ``num_heads/nranks`` heads of the packed QKV weight and bias
(``dist_spec (None, "mp", ...)``) and their rows of the output projection
(``("mp", None)``), its ``dim_feedforward/nranks`` columns of FFN1 and
their rows of FFN2; the LNs and the two output biases are whole. An
all-reduce over the group sums the ranks' partial products after the
output projection and after FFN2, before the bias and the residual.
Caches hold the rank's heads (``[2, B, num_heads/nranks, S, D]``, or the
slab / paged equivalents). Weights cross over as shards
(``convert.shard_state_dict``).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer import make_parameter
from ....ops.cuda.decode_attention import (cache_decode_step,
                                           cache_prefill_write)
from ....ops.cuda.paged_attention import (PagedCacheState, PagedKVCache,
                                          paged_forward)
from ..functional import (fused_feedforward, fused_multi_head_attention,
                          mp_reduce)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]


def _act(name):
    return {"gelu": lambda x: F.gelu(x, approximate=True),
            "relu": F.relu}[name]


def _tp_group(cls, nranks, ring_id):
    """The model-parallel group of a fused layer (None without tensor
    parallelism); its size must be ``nranks`` when that is given."""
    if nranks <= 1 and ring_id < 0:
        return None
    from ....distributed.fleet.meta_parallel.mp_layers import mp_group_of

    group = mp_group_of(None)
    n = 1 if group is None else group.nranks
    if nranks > 1 and n != nranks:
        raise ValueError(f"{cls}: nranks={nranks} but the model-parallel "
                         f"group has {n} ranks")
    return group if n > 1 else None


def _local(size, group, what):
    n = 1 if group is None else group.nranks
    if size % n:
        raise ValueError(f"{what}={size} is not divisible by nranks={n}")
    return size // n


def _mark(p, spec):
    p.is_distributed = True
    p.is_sharded = True
    p.dist_spec = spec
    return p


def _param(shape, device, dtype, attr=None, fill=None):
    """``attr``'s initializer, else ``fill`` everywhere (biases 0, LN
    scales 1), else XavierNormal."""
    return make_parameter(shape, attr, dtype, default_initializer=None
                          if fill is None else I.Constant(float(fill)),
                          device=device)


def _qkv_pack(x, qkv_weight, qkv_bias):
    """``[b, s, H] x [3, nh, hd, H] (+ [3, nh, hd]) -> [b, s, 3, nh, hd]``:
    the packed-QKV GEMM with the reference's ``trans_qkvw`` layout (its
    ``einsum("bsh,tndh->bstnd")``), the weight cast to x's dtype."""
    t, nh, hd, h = qkv_weight.shape
    w = qkv_weight.to(x.dtype).reshape(t * nh * hd, h)
    out = torch.matmul(x, w.t())
    if qkv_bias is not None:
        out = out + qkv_bias.to(x.dtype).reshape(-1)
    return out.reshape(x.shape[:-1] + (t, nh, hd))


class FusedMultiHeadAttention(nn.Module):
    """Pre- or post-LN, packed QKV, attention, the output projection and
    the dropout and residual in one layer."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.group = _tp_group("FusedMultiHeadAttention", nranks, ring_id)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        nh = _local(num_heads, self.group, "num_heads")
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.generator = generator
        kw = dict(device=device, dtype=dtype)
        h = embed_dim
        self.qkv_weight = _param((3, nh, self.head_dim, h),
                                 attr=qkv_weight_attr, **kw)
        self.qkv_bias = _param((3, nh, self.head_dim),
                               attr=qkv_bias_attr, fill=0, **kw)
        self.linear_weight = _param((nh * self.head_dim, h),
                                    attr=linear_weight_attr, **kw)
        if self.group is not None:
            _mark(self.qkv_weight, (None, "mp", None, None))
            _mark(self.qkv_bias, (None, "mp", None))
            _mark(self.linear_weight, ("mp", None))
        self.linear_bias = _param((h,), attr=linear_bias_attr, fill=0, **kw)
        self.pre_ln_scale = _param((h,), attr=pre_ln_scale_attr, fill=1,
                                   **kw)
        self.pre_ln_bias = _param((h,), attr=pre_ln_bias_attr, fill=0, **kw)
        self.ln_scale = _param((h,), attr=ln_scale_attr, fill=1, **kw)
        self.ln_bias = _param((h,), attr=ln_bias_attr, fill=0, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention: cache (incremental decode) is not "
                "supported — use FusedMultiTransformer's caches/time_step "
                "path; silently dropping it would compute non-cached "
                "attention")
        return fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self.epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            ring_id=-1 if self.group is None else 0,
            generator=self.generator)


class FusedFeedForward(nn.Module):
    """LN, linear1, the activation, dropout, linear2, dropout and the
    residual in one layer."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.group = _tp_group("FusedFeedForward", nranks, ring_id)
        ff = _local(dim_feedforward, self.group, "dim_feedforward")
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.epsilon = epsilon
        self.generator = generator
        kw = dict(device=device, dtype=dtype)
        self.linear1_weight = _param((d_model, ff),
                                     attr=linear1_weight_attr, **kw)
        self.linear1_bias = _param((ff,), attr=linear1_bias_attr, fill=0,
                                   **kw)
        self.linear2_weight = _param((ff, d_model),
                                     attr=linear2_weight_attr, **kw)
        if self.group is not None:
            _mark(self.linear1_weight, (None, "mp"))
            _mark(self.linear1_bias, ("mp",))
            _mark(self.linear2_weight, ("mp", None))
        self.linear2_bias = _param((d_model,), attr=linear2_bias_attr,
                                   fill=0, **kw)
        self.ln1_scale = _param((d_model,), attr=ln1_scale_attr, fill=1,
                                **kw)
        self.ln1_bias = _param((d_model,), attr=ln1_bias_attr, fill=0, **kw)
        self.ln2_scale = _param((d_model,), attr=ln2_scale_attr, fill=1,
                                **kw)
        self.ln2_bias = _param((d_model,), attr=ln2_bias_attr, fill=0, **kw)

    def forward(self, src):
        return fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            ring_id=-1 if self.group is None else 0,
            generator=self.generator)


# the per-layer parameter lists of FusedMultiTransformer, in the
# reference's registration order
_LISTS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
          "linear_weights", "linear_biases", "ffn_ln_scales",
          "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
          "ffn2_biases")
# the reference's dist_specs of the lists a tensor-parallel layer splits
_MP_SPECS = {"qkv_weights": (None, "mp", None, None),
             "qkv_biases": (None, "mp", None),
             "linear_weights": ("mp", None), "ffn1_weights": (None, "mp"),
             "ffn1_biases": ("mp",), "ffn2_weights": ("mp", None)}


class FusedMultiTransformer(nn.Module):
    """The whole decoder stack as one layer, pre-LN only, like the
    reference: one call runs every layer.

    ``forward(src, caches=..., time_step=...)``: without caches the context
    attention over the whole input (causal); with one cache per layer the
    context phase (``time_step`` None) writes the prompt and the decode
    phase appends one token at ``time_step`` (see the module doc). Returns
    ``out``, or ``(out, caches)`` with caches."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.group = _tp_group("FusedMultiTransformer", nranks, ring_id)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN only, as the "
                             "reference kernel")
        if not trans_qkvw:
            raise ValueError("only the [3, nh, hd, H] qkv layout "
                             "(trans_qkvw=True) is supported")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        if num_layers == -1:
            num_layers = (len(qkv_weight_attrs)
                          if isinstance(qkv_weight_attrs, (list, tuple))
                          else 1)
        self.num_layers = num_layers
        # this rank's heads and FFN columns (all of them without tensor
        # parallelism)
        nh = self.local_heads = _local(num_heads, self.group, "num_heads")
        ff = _local(dim_feedforward, self.group, "dim_feedforward")
        h, hd = embed_dim, self.head_dim
        kw = dict(device=device, dtype=dtype)
        shapes = {"ln_scales": ((h,), 1), "ln_biases": ((h,), 0),
                  "qkv_weights": ((3, nh, hd, h), None),
                  "qkv_biases": ((3, nh, hd), 0),
                  "linear_weights": ((nh * hd, h), None),
                  "linear_biases": ((h,), 0),
                  "ffn_ln_scales": ((h,), 1), "ffn_ln_biases": ((h,), 0),
                  "ffn1_weights": ((h, ff), None),
                  "ffn1_biases": ((ff,), 0),
                  "ffn2_weights": ((ff, h), None),
                  "ffn2_biases": ((h,), 0)}
        attrs = {"ln_scales": ln_scale_attrs, "ln_biases": ln_bias_attrs,
                 "qkv_weights": qkv_weight_attrs,
                 "qkv_biases": qkv_bias_attrs,
                 "linear_weights": linear_weight_attrs,
                 "linear_biases": linear_bias_attrs,
                 "ffn_ln_scales": ffn_ln_scale_attrs,
                 "ffn_ln_biases": ffn_ln_bias_attrs,
                 "ffn1_weights": ffn1_weight_attrs,
                 "ffn1_biases": ffn1_bias_attrs,
                 "ffn2_weights": ffn2_weight_attrs,
                 "ffn2_biases": ffn2_bias_attrs}
        for lst in _LISTS:
            setattr(self, lst, [])
        for i in range(num_layers):
            for lst in _LISTS:
                shape, fill = shapes[lst]
                attr = attrs[lst]
                if isinstance(attr, (list, tuple)):
                    attr = attr[i]
                p = _param(shape, attr=attr, fill=fill, **kw)
                if self.group is not None and lst in _MP_SPECS:
                    _mark(p, _MP_SPECS[lst])
                self.register_parameter(f"{lst}_{i}", p)
                getattr(self, lst).append(p)

    def _attention(self, i, x, cache, time_step, attn_mask=None):
        b, s, _ = x.shape
        q, k, v = _qkv_pack(x, self.qkv_weights[i],
                            self.qkv_biases[i]).unbind(dim=2)
        new_cache = None

        def ctx_attention():
            # a given mask already encodes causality and padding, so it
            # replaces the built-in causal mask, as in the reference
            if attn_mask is not None:
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, dropout_p=0.0,
                    training=False)
            return F.flash_attention(q, k, v, causal=True,
                                     training=self.training)[0]

        if cache is None:
            out = ctx_attention()
        elif isinstance(cache, (PagedKVCache, PagedCacheState)):
            out, new_cache = paged_forward(cache, q, k, v, ctx_attention,
                                           time_step=time_step)
        elif time_step is None:
            new_cache = cache_prefill_write(cache, k, v)
            out = ctx_attention()
        else:
            out, new_cache = cache_decode_step(cache, q, k, v, time_step)
        w = self.linear_weights[i]
        out = mp_reduce(torch.matmul(out.reshape(b, s, w.shape[0]), w),
                        self.group) + self.linear_biases[i]
        return out, new_cache

    def _ffn(self, i, x):
        h = _act(self.activation)(torch.matmul(x, self.ffn1_weights[i])
                                  + self.ffn1_biases[i])
        return mp_reduce(torch.matmul(h, self.ffn2_weights[i]),
                         self.group) + self.ffn2_biases[i]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        unsupported = {"pre_caches": pre_caches, "rotary_embs": rotary_embs,
                       "seq_lens": seq_lens}
        bad = [k for k, v in unsupported.items() if v is not None]
        if rotary_emb_dims:
            bad.append("rotary_emb_dims")
        if bad:
            raise NotImplementedError(
                f"FusedMultiTransformer: unsupported arguments {bad} — "
                "silently dropping them would compute wrong attention")
        if attn_mask is not None and time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer: attn_mask in the decode phase is not "
                "supported (the decode kernel masks by sequence length)")
        x = src
        new_caches: List = []
        for i in range(self.num_layers):
            residual = x
            ln = F.layer_norm(x, [self.embed_dim], self.ln_scales[i],
                              self.ln_biases[i], self.epsilon)
            attn, new_c = self._attention(
                i, ln, None if caches is None else caches[i], time_step,
                attn_mask=attn_mask)
            if caches is not None:
                new_caches.append(new_c if new_c is not None else caches[i])
            x = residual + attn
            residual = x
            ln2 = F.layer_norm(x, [self.embed_dim], self.ffn_ln_scales[i],
                               self.ffn_ln_biases[i], self.epsilon)
            x = residual + self._ffn(i, ln2)
        if caches is not None:
            return x, new_caches
        return x


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
