"""Tensor-parallel layers (after
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``):
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear`` and ``ParallelCrossEntropy``.

The reference holds each layer's FULL parameter and annotates it with a
``dist_spec`` over the ``mp`` mesh axis, and XLA shards it and inserts the
Megatron collectives. The port runs one process per rank, and each rank
holds ITS shard (the parameter keeps the reference's ``dist_spec`` and
``is_distributed``, and ``is_sharded`` says it is already this rank's
slice): a column layer ``out/mp`` output columns, a row layer ``in/mp``
input rows, the embedding ``V/mp`` vocabulary rows. The Megatron ``f`` /
``g`` conjugates are autograd functions over the ``mp`` group:

* column: ``f`` (identity forward, all-reduce of the input's gradient),
  the local GEMM, then with ``gather_output`` an all-gather of the output
  columns (whose backward keeps this rank's slice);
* row: the input split along its last dim unless ``input_is_parallel``
  (whose backward all-gathers), the local GEMM, ``g`` (all-reduce forward,
  identity backward), then the replicated bias;
* embedding: rows outside this rank's vocabulary slice look up zeros, then
  ``g``;
* cross entropy: the vocabulary-parallel logsumexp (global max, sum of
  exponentials and gold logit each all-reduced), whose backward is
  ``softmax - onehot`` on this rank's columns; ``ignore_index`` rows give
  0 and no gradient.

The group is ``mp_group``, else ``fleet``'s model-parallel group, else the
world; one rank (or no world) is the plain layer. Parameters are drawn
with the full shape's fans (XavierNormal) inside the tracker's
``model_parallel_rng`` state when it is registered, so shards differ
across ranks.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer import make_parameter
from ...collective import all_gather, all_reduce, ReduceOp
from .random import MODEL_PARALLEL_RNG, get_rng_state_tracker

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mp_group_of"]


def mp_group_of(mp_group=None):
    """The model-parallel group a layer runs over (see the module doc);
    None for a single process."""
    if mp_group is not None:
        return mp_group
    from ..fleet_base import fleet_state

    if fleet_state.initialized:
        return fleet_state.hcg.get_model_parallel_group()
    from ...parallel import get_group, is_initialized

    return get_group() if is_initialized() else None


def _n(group) -> int:
    return 1 if group is None else group.nranks


def _r(group) -> int:
    return 0 if group is None else group.rank


def _split_last(x, group):
    return x.chunk(_n(group), dim=-1)[_r(group)].contiguous()


def _gather_last(x, group):
    return torch.cat(all_gather([], x.contiguous(), group), dim=-1)


class _CopyToMP(torch.autograd.Function):
    """Megatron ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """Megatron ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather along the last dim; the backward keeps this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _split_last(g, ctx.group), None


class _ScatterToMP(torch.autograd.Function):
    """This rank's slice of the last dim; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_to_mp(x, group):
    return x if _n(group) <= 1 else _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return x if _n(group) <= 1 else _ReduceFromMP.apply(x, group)


def gather_from_mp(x, group):
    return x if _n(group) <= 1 else _GatherFromMP.apply(x, group)


def scatter_to_mp(x, group):
    return x if _n(group) <= 1 else _ScatterToMP.apply(x, group)


def _local(size: int, group, what: str) -> int:
    n = _n(group)
    if size % n:
        raise ValueError(f"{what} {size} is not divisible by the mp "
                         f"degree {n}")
    return size // n


@contextlib.contextmanager
def _mp_rng():
    tracker = get_rng_state_tracker()
    if MODEL_PARALLEL_RNG in tracker.states_:
        with tracker.rng_state(MODEL_PARALLEL_RNG):
            yield
    else:
        yield


def _sharded(p, spec):
    p.is_distributed = True
    p.is_sharded = True
    p.dist_spec = spec
    return p


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.group = mp_group_of(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_part = _local(num_embeddings, self.group, "num_embeddings")
        self.vocab_start = _r(self.group) * self.per_part
        with _mp_rng():
            self.weight = _sharded(make_parameter(
                (self.per_part, embedding_dim), weight_attr, dtype,
                default_initializer=I.XavierNormal(
                    fan_in=num_embeddings, fan_out=embedding_dim),
                device=device), ("mp", None))

    def forward(self, x):
        if _n(self.group) <= 1:
            return F.embedding(x, self.weight)
        local = x - self.vocab_start
        out_of = (local < 0) | (local >= self.per_part)
        out = F.embedding(local.masked_fill(out_of, 0), self.weight)
        out = out.masked_fill(out_of[..., None], 0.0)
        return reduce_from_mp(out, self.group)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.group = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.output_size_per_partition = _local(out_features, self.group,
                                                "out_features")
        with _mp_rng():
            self.weight = _sharded(make_parameter(
                (in_features, self.output_size_per_partition), weight_attr,
                dtype, default_initializer=I.XavierNormal(
                    fan_in=in_features, fan_out=out_features),
                device=device), (None, "mp"))
        self.bias = (_sharded(make_parameter(
            (self.output_size_per_partition,), None, dtype, is_bias=True,
            device=device), ("mp",)) if has_bias else None)

    def forward(self, x):
        out = torch.matmul(copy_to_mp(x, self.group), self.weight)
        if self.bias is not None:
            out = out + self.bias
        return gather_from_mp(out, self.group) if self.gather_output \
            else out


class RowParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.group = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.input_size_per_partition = _local(in_features, self.group,
                                               "in_features")
        with _mp_rng():
            self.weight = _sharded(make_parameter(
                (self.input_size_per_partition, out_features), weight_attr,
                dtype, default_initializer=I.XavierNormal(
                    fan_in=in_features, fan_out=out_features),
                device=device), ("mp", None))
        if has_bias:
            # added after the reduction: replicated
            self.bias = make_parameter((out_features,), None, dtype,
                                       is_bias=True, device=device)
            self.bias.dist_spec = None
        else:
            self.bias = None

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_mp(x, self.group)
        out = reduce_from_mp(torch.matmul(x, self.weight), self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        lg = logits.float()
        vl = lg.shape[-1]
        start = group.rank * vl
        m = lg.max(dim=-1).values
        all_reduce(m, op=ReduceOp.MAX, group=group)
        ex = torch.exp(lg - m[..., None])
        s = ex.sum(dim=-1)
        all_reduce(s, group=group)
        local = label.long() - start
        in_range = (local >= 0) & (local < vl)
        safe = local.clamp(0, vl - 1)
        gold = torch.gather(lg, -1, safe[..., None])[..., 0]
        gold = torch.where(in_range, gold, torch.zeros_like(gold))
        all_reduce(gold, group=group)
        loss = torch.log(s) + m - gold
        ignored = label.long() == ignore_index
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
        ctx.save_for_backward(ex / s[..., None], in_range, safe, ignored)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        soft, in_range, safe, ignored = ctx.saved_tensors
        grad = soft.clone()
        hit = torch.zeros_like(grad).scatter_(
            -1, safe[..., None], in_range[..., None].to(grad.dtype))
        grad = (grad - hit) * torch.where(ignored, torch.zeros_like(g),
                                          g)[..., None]
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy over vocabulary-sharded logits
    (``input`` holds this rank's ``V/mp`` columns); ``label`` holds global
    ids, ``[...]`` or ``[..., 1]``. One rank: ``F.cross_entropy`` with
    ``reduction="none"``, as the reference off the mesh."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = mp_group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if _n(self.group) <= 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        if label.dim() == input.dim():
            label = label[..., 0]
        return _VocabParallelCE.apply(input, label, self.group,
                                      self.ignore_index)
