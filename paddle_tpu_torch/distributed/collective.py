"""Eager collectives over ``torch.distributed`` (after
``paddle_tpu/distributed/collective.py``): the ones the context-parallel
path calls. ``group`` is a :class:`~.topology.Group` (None: the world);
``dst`` / ``src`` are global ranks, as in the reference. NCCL on the card,
gloo on the CPU; a collective on a group of one rank returns at once.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .topology import Group

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_to_all", "barrier",
           "send", "recv", "p2p_exchange"]


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


def all_to_all(out_tensor_list: List, in_tensor_list: List,
               group: Optional[Group] = None, sync_op=True):
    """Member j receives ``in_tensor_list[j]`` of every member i at
    ``out_tensor_list[i]`` (one shape for all), as one
    ``all_to_all_single`` (which gloo also runs)."""
    n = _size(group)
    if n <= 1:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    stacked = torch.stack(list(in_tensor_list))
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=_pg(group))
    out_tensor_list.extend(out.unbind(0))
    return out_tensor_list


def barrier(group: Optional[Group] = None):
    if _size(group) > 1:
        dist.barrier(group=_pg(group))


def send(tensor: torch.Tensor, dst: int, group: Optional[Group] = None,
         sync_op=True):
    dist.send(tensor.contiguous(), dst, group=_pg(group))
    return tensor


def recv(tensor: torch.Tensor, src: int, group: Optional[Group] = None,
         sync_op=True):
    """Receives into ``tensor`` (contiguous) in place."""
    dist.recv(tensor, src, group=_pg(group))
    return tensor


def p2p_exchange(send_tensor: torch.Tensor, dst: int,
                 recv_tensor: torch.Tensor, src: int,
                 group: Optional[Group] = None):
    """Send ``send_tensor`` to global rank ``dst`` and receive
    ``recv_tensor`` from ``src`` as ONE batched P2P operation
    (``batch_isend_irecv``), so that every rank of a ring posts its send
    and its receive together and no order of ranks can deadlock. Waits for
    both; returns ``recv_tensor``."""
    ops = [dist.P2POp(dist.isend, send_tensor.contiguous(), dst, _pg(group)),
           dist.P2POp(dist.irecv, recv_tensor, src, _pg(group))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv_tensor
