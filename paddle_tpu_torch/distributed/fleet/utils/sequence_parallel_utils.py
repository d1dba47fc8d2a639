"""Megatron sequence parallelism (after
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``).

Between the tensor-parallel blocks the activations are cut along the
sequence (dim 0 of the reference's ``[seq, batch, hidden]`` layout) over
the ``mp`` group, which divides their memory by the ``mp`` degree. The
reference writes this as sharding constraints for XLA; the port runs one
process a rank, so these are the collectives themselves over the ``mp``
group (``mp_group``, else ``fleet``'s model-parallel group, else the
world), as ``torch.autograd.Function``s:

* ``ScatterOp`` / :func:`scatter`: forward keeps this rank's slice of the
  sequence; backward all-gathers the gradient;
* ``GatherOp`` / :func:`all_gather`: forward all-gathers the slices;
  backward keeps this rank's slice of the gradient;
* ``AllGatherOp``: forward all-gathers; backward reduce-scatters (the
  gradient of a gathered input that every rank used whole);
* ``ReduceScatterOp``: forward reduce-scatters (sum, then this rank's
  slice); backward all-gathers.

``ColumnSequenceParallelLinear`` all-gathers its sequence-parallel input
(``AllGatherOp``) and multiplies by this rank's column shard;
``RowSequenceParallelLinear`` multiplies its column-parallel input by this
rank's row shard and reduce-scatters the partial sums back to a sequence
slice (``ReduceScatterOp``). Their weights keep the reference's
``dist_spec`` and are this rank's shards, as the mp layers' are.

A replicated parameter used inside the sequence-parallel region (a
LayerNorm's, the row layer's bias) sees only this rank's tokens, so its
gradient is a part of the whole: ``mark_as_sequence_parallel_parameter``
marks it, and the gradients of the marked parameters are summed over the
``mp`` group by the hook of :func:`create_fused_allreduce_gradient_hook`,
or by ``HybridParallelOptimizer.step``.
"""
from __future__ import annotations

import torch
from torch import nn

from ....nn import initializer as I
from ....nn.layer import make_parameter
from ..meta_parallel.mp_layers import _local, _mp_rng, _sharded, mp_group_of
from ...collective import ReduceOp, all_gather as _all_gather, all_reduce

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "scatter", "all_gather", "mark_as_sequence_parallel_parameter",
    "is_sequence_parallel_parameter",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
    "create_fused_allreduce_gradient_hook",
]


def _n(group) -> int:
    return 1 if group is None else group.nranks


def _slice(x, group):
    n = _n(group)
    if x.shape[0] % n:
        raise ValueError(f"sequence length {x.shape[0]} is not divisible "
                         f"by the mp degree {n}")
    return x.chunk(n, dim=0)[group.rank].contiguous()


def _gather(x, group):
    return torch.cat(_all_gather([], x.contiguous(), group), dim=0)


def _reduce_scatter(x, group):
    full = all_reduce(x.contiguous().clone(), op=ReduceOp.SUM, group=group)
    return _slice(full, group)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _Op:
    fn = None

    @classmethod
    def apply(cls, x, group=None):
        group = mp_group_of(group)
        if _n(group) <= 1:
            return x
        return cls.fn.apply(x, group)


class ScatterOp(_Op):
    fn = _Scatter


class GatherOp(_Op):
    fn = _Gather


class AllGatherOp(_Op):
    fn = _AllGather


class ReduceScatterOp(_Op):
    fn = _ReduceScatter


def scatter(x, group=None):
    """This rank's slice of the sequence (``ScatterOp``)."""
    return ScatterOp.apply(x, group)


def all_gather(x, group=None):
    """The whole sequence from the ranks' slices (``GatherOp``)."""
    return GatherOp.apply(x, group)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return bool(getattr(parameter, "sequence_parallel", False))


def create_fused_allreduce_gradient_hook(parameter_list,
                                         accumulation_steps=1, group=None):
    """A hook (call it after the backward) that sums the gradients of the
    marked parameters of ``parameter_list`` over the ``mp`` group."""

    def hook():
        g = mp_group_of(group)
        if _n(g) <= 1:
            return
        for p in parameter_list:
            if is_sequence_parallel_parameter(p) and p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.SUM, group=g)

    return hook


class ColumnSequenceParallelLinear(nn.Module):
    """A column-parallel linear whose input is sequence-parallel: the
    input is all-gathered along the sequence, the output holds this
    rank's ``out/mp`` columns (``gather_output`` is not supported, as
    upstream's)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear: gather_output "
                             "is not supported")
        self.group = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = False
        local = _local(out_features, self.group, "out_features")
        with _mp_rng():
            self.weight = _sharded(make_parameter(
                (in_features, local), weight_attr, dtype,
                default_initializer=I.XavierNormal(fan_in=in_features,
                                                   fan_out=out_features),
                device=device), (None, "mp"))
        self.bias = (_sharded(make_parameter(
            (local,), None, dtype, is_bias=True, device=device), ("mp",))
            if has_bias else None)

    def forward(self, x):
        out = torch.matmul(AllGatherOp.apply(x, self.group), self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class RowSequenceParallelLinear(nn.Module):
    """A row-parallel linear whose output is sequence-parallel: the input
    holds this rank's ``in/mp`` features, the partial sums are
    reduce-scattered along the sequence, then the replicated bias (marked
    sequence-parallel) is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear: the input must be "
                             "parallel (input_is_parallel=True)")
        self.group = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = True
        local = _local(in_features, self.group, "in_features")
        with _mp_rng():
            self.weight = _sharded(make_parameter(
                (local, out_features), weight_attr, dtype,
                default_initializer=I.XavierNormal(fan_in=in_features,
                                                   fan_out=out_features),
                device=device), ("mp", None))
        if has_bias:
            self.bias = make_parameter((out_features,), None, dtype,
                                       is_bias=True, device=device)
            self.bias.dist_spec = None
            mark_as_sequence_parallel_parameter(self.bias)
        else:
            self.bias = None

    def forward(self, x):
        out = ReduceScatterOp.apply(torch.matmul(x, self.weight),
                                    self.group)
        if self.bias is not None:
            out = out + self.bias
        return out
