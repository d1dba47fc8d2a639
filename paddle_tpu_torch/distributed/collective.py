"""Eager collectives over ``torch.distributed`` (after
``paddle_tpu/distributed/collective.py``). ``group`` is a
:class:`~.topology.Group` (None: the world); ``dst`` / ``src`` are global
ranks, as in the reference. A collective on a group of one rank returns at
once.

The backend is the group's: NCCL on the card, gloo on the CPU, or gloo on
the card when the world was made so (``init_parallel_env(backend=
"gloo")``). Gloo runs ``all_reduce``, ``broadcast`` and ``all_gather`` on
CUDA tensors but not every collective, so for a gloo group holding CUDA
tensors three are built from the ones it has: ``all_to_all`` from one
``all_gather`` of every member's whole input (each member keeps its
slices), ``scatter`` from a ``broadcast`` of the stacked list, and (on any
gloo group) ``reduce_scatter`` from an ``all_reduce`` and a slice. NCCL
groups, and gloo groups on the CPU for ``all_to_all``, take the native
call. Gloo's point-to-point calls (``send``, ``recv``, ``p2p_exchange``,
``p2p_batch``) read and write host memory only, so on a gloo group a CUDA
tensor travels through a host buffer: a copy to the host before the send,
a host buffer for the receive and a copy onto the card after it. NCCL
groups and CPU tensors send and receive in place.

:class:`fcollectives` are the reference's in-program collectives with a
group in place of a mesh axis name, as autograd functions: each backward
is the transpose of its forward (``all_reduce`` ↔ ``all_reduce``,
``all_gather`` ↔ ``reduce_scatter``, ``all_to_all`` ↔ the inverse
``all_to_all``), JAX's rules for ``psum``, ``all_gather``,
``psum_scatter`` and ``all_to_all``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .topology import Group

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "all_to_all", "all_to_all_single", "broadcast", "reduce",
           "scatter", "reduce_scatter", "barrier", "send", "recv",
           "p2p_exchange", "p2p_batch", "fcollectives"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
        ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT,
        ReduceOp.AVG: dist.ReduceOp.SUM}  # AVG divides after (gloo has none)


def _pg(group: Optional[Group]):
    return None if group is None else group.process_group


def _size(group: Optional[Group]) -> int:
    return dist.get_world_size(_pg(group)) if dist.is_initialized() else 1


def _rank(group: Optional[Group]) -> int:
    return dist.get_rank(_pg(group)) if dist.is_initialized() else 0


def _gloo(group: Optional[Group]) -> bool:
    return dist.get_backend(_pg(group)) == "gloo"


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM,
               group: Optional[Group] = None, sync_op=True):
    """In place over the group; returns ``tensor``."""
    n = _size(group)
    if n > 1:
        dist.all_reduce(tensor, op=_OPS[op], group=_pg(group))
        if op == ReduceOp.AVG:
            tensor.div_(n)
    return tensor


def all_gather(tensor_list: List, tensor: torch.Tensor,
               group: Optional[Group] = None, sync_op=True):
    """Appends every member's ``tensor`` (same shape on every rank) to
    ``tensor_list``, in group-rank order."""
    n = _size(group)
    if n <= 1:
        tensor_list.append(tensor)
        return tensor_list
    parts = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(parts, tensor.contiguous(), group=_pg(group))
    tensor_list.extend(parts)
    return tensor_list


def all_gather_object(object_list: List, obj,
                      group: Optional[Group] = None):
    """Appends every member's picklable ``obj`` to ``object_list``, in
    group-rank order."""
    n = _size(group)
    if n <= 1:
        object_list.append(obj)
        return object_list
    out = [None] * n
    dist.all_gather_object(out, obj, group=_pg(group))
    object_list.extend(out)
    return object_list


def all_to_all_single(x: torch.Tensor,
                      group: Optional[Group] = None) -> torch.Tensor:
    """``x`` ``[n, ...]`` (n = group size): member j receives row j of
    every member i at row i of the result. One native ``all_to_all_single``,
    or, on a gloo group holding CUDA tensors, one ``all_gather`` of the
    whole ``x`` from which each member keeps its rows."""
    n = _size(group)
    if n <= 1:
        return x
    x = x.contiguous()
    if x.is_cuda and _gloo(group):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=_pg(group))
        me = _rank(group)
        return torch.stack([p[me] for p in parts])
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=_pg(group))
    return out


def all_to_all(out_tensor_list: List, in_tensor_list: List,
               group: Optional[Group] = None, sync_op=True):
    """Member j receives ``in_tensor_list[j]`` of every member i at
    ``out_tensor_list[i]`` (one shape for all)."""
    n = _size(group)
    if n <= 1:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    out = all_to_all_single(torch.stack(list(in_tensor_list)), group)
    out_tensor_list.extend(out.unbind(0))
    return out_tensor_list


def broadcast(tensor: torch.Tensor, src: int, group: Optional[Group] = None,
              sync_op=True):
    """``src``'s ``tensor`` into every member's, in place."""
    if group is not None and src not in group.ranks:
        raise ValueError(f"broadcast src rank {src} is not a member of "
                         f"group {group.ranks}")
    if _size(group) > 1:
        dist.broadcast(tensor, src, group=_pg(group))
    return tensor


def reduce(tensor: torch.Tensor, dst: int, op=ReduceOp.SUM,
           group: Optional[Group] = None, sync_op=True):
    """As the reference: an ``all_reduce``, so every member (``dst``
    included) holds the reduced value."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op=True):
    """Member i receives ``src``'s ``tensor_list[i]`` into ``tensor``."""
    n = _size(group)
    if n <= 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    me = _rank(group)
    is_src = (dist.get_rank() == src)
    if is_src and len(tensor_list or []) != n:
        raise ValueError("scatter: src needs one tensor per group rank")
    if tensor.is_cuda and _gloo(group):
        stacked = (torch.stack(list(tensor_list)) if is_src else
                   torch.empty((n,) + tuple(tensor.shape),
                               dtype=tensor.dtype, device=tensor.device))
        dist.broadcast(stacked, src, group=_pg(group))
        tensor.copy_(stacked[me])
        return tensor
    dist.scatter(tensor, [t.contiguous() for t in tensor_list]
                 if is_src else None, src=src, group=_pg(group))
    return tensor


def reduce_scatter(tensor: torch.Tensor, tensor_list: List,
                   op=ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op=True):
    """Member i receives the reduction over members of their
    ``tensor_list[i]``, into ``tensor``."""
    n = _size(group)
    if n <= 1:
        tensor.copy_(tensor_list[0])
        return tensor
    if _gloo(group):
        stacked = all_reduce(torch.stack(list(tensor_list)), op, group)
        tensor.copy_(stacked[_rank(group)])
        return tensor
    dist.reduce_scatter(tensor, [t.contiguous() for t in tensor_list],
                        op=_OPS[op], group=_pg(group))
    if op == ReduceOp.AVG:
        tensor.div_(n)
    return tensor


def barrier(group: Optional[Group] = None):
    if _size(group) > 1:
        dist.barrier(group=_pg(group))


def _host_staged(tensor: torch.Tensor, group: Optional[Group]) -> bool:
    """Whether a point-to-point transfer of ``tensor`` over ``group`` goes
    through a host buffer: a CUDA tensor on a gloo group (see the module
    doc)."""
    return tensor.is_cuda and _gloo(group)


def _send_buffer(tensor, group):
    if _host_staged(tensor, group):
        return tensor.detach().to("cpu")
    return tensor.contiguous()


def _recv_buffer(tensor, group):
    if _host_staged(tensor, group):
        return torch.empty(tuple(tensor.shape), dtype=tensor.dtype,
                           device="cpu")
    if not tensor.is_contiguous():
        raise ValueError("recv: the tensor received into must be "
                         "contiguous")
    return tensor


def send(tensor: torch.Tensor, dst: int, group: Optional[Group] = None,
         sync_op=True):
    dist.send(_send_buffer(tensor, group), dst, group=_pg(group))
    return tensor


def recv(tensor: torch.Tensor, src: int, group: Optional[Group] = None,
         sync_op=True):
    """Receives into ``tensor`` (contiguous) in place."""
    buf = _recv_buffer(tensor, group)
    dist.recv(buf, src, group=_pg(group))
    if buf is not tensor:
        tensor.copy_(buf)
    return tensor


class P2PSends:
    """The send half of a :func:`p2p_batch`: ``wait()`` blocks until every
    send has left, and until then holds the buffers they read."""

    def __init__(self, works, buffers):
        self._works = works
        self._buffers = buffers

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._buffers = [], []


def p2p_batch(sends=(), recvs=(), group: Optional[Group] = None,
              wait_sends: bool = True):
    """Post every ``(tensor, dst[, tag])`` of ``sends`` and every
    ``(tensor, src[, tag])`` of ``recvs`` (global ranks) as ONE batched
    point-to-point operation (``batch_isend_irecv``), so that ranks that
    send to each other post their sends and receives together and no order
    of ranks can deadlock. Waits for the receives (each tensor then holds
    what arrived). With ``wait_sends`` it waits for the sends too and
    returns None; otherwise it returns a :class:`P2PSends` to wait on
    later, which keeps the send buffers alive."""
    ops, send_bufs, landed = [], [], []
    for item in sends:
        t, peer, tag = (tuple(item) + (0,))[:3]
        buf = _send_buffer(t, group)
        send_bufs.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, _pg(group), tag))
    n_send = len(ops)
    for item in recvs:
        t, peer, tag = (tuple(item) + (0,))[:3]
        buf = _recv_buffer(t, group)
        landed.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, _pg(group), tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    for w in works[n_send:]:
        w.wait()
    for t, buf in landed:
        if buf is not t:
            t.copy_(buf)
    pending = P2PSends(list(works[:n_send]), send_bufs)
    if wait_sends:
        pending.wait()
        return None
    return pending


def p2p_exchange(send_tensor: torch.Tensor, dst: int,
                 recv_tensor: torch.Tensor, src: int,
                 group: Optional[Group] = None):
    """Send ``send_tensor`` to global rank ``dst`` and receive
    ``recv_tensor`` from ``src`` as ONE batched P2P operation
    (:func:`p2p_batch`), so that every rank of a ring posts its send and
    its receive together and no order of ranks can deadlock. Waits for
    both; returns ``recv_tensor``."""
    p2p_batch([(send_tensor, dst)], [(recv_tensor, src)], group)
    return recv_tensor


# ------------------------------------------------ autograd-aware forms
def _gather_cat(x, group, axis):
    parts = all_gather([], x, group)
    return torch.cat(parts, dim=axis)


def _sum_scatter(x, group, axis):
    n = _size(group)
    full = all_reduce(x.contiguous().clone(), group=group)
    return full.chunk(n, dim=axis)[_rank(group)].contiguous()


def _a2a(x, group, split_axis, concat_axis):
    n = _size(group)
    parts = torch.stack(x.chunk(n, dim=split_axis))
    got = all_to_all_single(parts, group)
    return torch.cat(got.unbind(0), dim=concat_axis)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), op=op, group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _gather_cat(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g, ctx.group, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _sum_scatter(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


class fcollectives:
    """The reference's functional collectives (``jax.lax`` over a mesh
    axis) over a :class:`~.topology.Group` instead, differentiable. The
    tiled forms: ``all_gather`` concatenates the members' ``x`` along
    ``axis``; ``reduce_scatter`` sums and keeps this member's
    ``1/n`` along ``axis``; ``all_to_all`` splits ``x`` along
    ``split_axis`` and concatenates what arrives along ``concat_axis``."""

    @staticmethod
    def all_reduce(x, group: Optional[Group] = None, op=ReduceOp.SUM):
        if _size(group) <= 1:
            return x
        if op != ReduceOp.SUM:
            # max / min / mean: the forward only (no transpose is defined)
            return all_reduce(x.detach().contiguous().clone(), op=op,
                              group=group)
        return _AllReduce.apply(x, group, op)

    psum = all_reduce

    @staticmethod
    def all_gather(x, group: Optional[Group] = None, axis: int = 0,
                   tiled: bool = True):
        if _size(group) <= 1:
            return x if tiled else x.unsqueeze(axis)
        out = _AllGather.apply(x, group, axis)
        if not tiled:
            n = _size(group)
            shape = list(x.shape)
            shape.insert(axis, n)
            out = out.reshape(shape)
        return out

    @staticmethod
    def reduce_scatter(x, group: Optional[Group] = None, axis: int = 0):
        if _size(group) <= 1:
            return x
        return _ReduceScatter.apply(x, group, axis)

    @staticmethod
    def all_to_all(x, group: Optional[Group] = None, split_axis: int = 0,
                   concat_axis: int = 0):
        if _size(group) <= 1:
            return x
        return _AllToAll.apply(x, group, split_axis, concat_axis)

    @staticmethod
    def axis_index(group: Optional[Group] = None) -> int:
        return _rank(group)
