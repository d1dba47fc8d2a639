"""The process world (after ``paddle_tpu/distributed/parallel.py``).

One process per rank over ``torch.distributed``, each driving one card:
NCCL on the card, gloo when the caller asks for ``device="cpu"``. A caller
may name the backend (``backend="gloo"`` on the card: two ranks sharing one
card, which NCCL refuses); nothing here picks one by itself when another
fails. The
reference's launch environment is read as it is (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_MASTER``); a caller may pass the rank,
the world size and the rendezvous (``init_method``) instead. A world of one
needs no rendezvous: it runs on an in-process store. A world that
``torch.distributed`` already holds is adopted as it is;
:func:`destroy_process_group` ends the world and this module's state with
it, and a process that started a world here runs it at exit, before the
interpreter finalizes: groups that outlived ``torch.distributed``'s own
teardown would keep gloo's worker threads into finalization, where one
that drops the last reference to a tensor aborts the process ("terminate
called without an active exception").

:class:`DataParallel` keeps the reference's explicit contract: after the
backward, ``apply_collective_grads()`` averages the gradients over the dp
group, and ``no_sync()`` suspends that. The gradients travel in buckets
(:func:`allreduce_buckets`): each bucket is the gradients of consecutive
parameters flattened into one buffer of about ``comm_buffer_size`` MB and
all-reduced in one call, where the reference reduces one parameter a
call. Each element is still the sum of the same values, so the result is
the per-parameter one.

Expert parameters of an expert-parallel ``MoELayer`` (``expert_group`` set:
each rank holds other experts under their own names) take no part in the
dp average and are not broadcast at wrap: their gradient, the sum over the
group's ranks of each rank's mean loss's, is divided by the group's size
instead (:func:`sync_gradients`).
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "destroy_process_group", "new_group",
           "subgroup", "get_group", "set_mesh", "get_mesh", "current_mesh",
           "get_device", "DataParallel", "allreduce_buckets", "buckets",
           "is_expert_parallel", "sync_gradients"]


class ParallelEnv:
    """The launch environment contract of the reference."""

    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints: List[str] = eps.split(",") if eps else []
        self.master = os.environ.get(
            "PADDLE_MASTER",
            self.trainer_endpoints[0] if self.trainer_endpoints else "",
        )
        sel = os.environ.get("FLAGS_selected_gpus", "")
        self.device_id = int(sel.split(",")[0]) if sel else None
        self.initialized = False

    @property
    def local_rank(self):
        return self.rank

    @property
    def nranks(self):
        return self.world_size

    def __repr__(self):
        return (f"ParallelEnv(rank={self.rank}, world_size={self.world_size}, "
                f"master={self.master!r})")


_env = ParallelEnv()
_default_group = None
_subgroups: dict = {}
_global_mesh = None
_device: Optional[torch.device] = None
_exit_hook = False


def init_parallel_env(strategy=None, *, device=None, init_method=None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      backend: Optional[str] = None, timeout=None):
    """Initialise the process world and return its group. Idempotent.

    ``device``: None or ``"cuda"`` (this rank's card) or ``"cpu"``.
    ``backend``: None takes NCCL on the card and gloo on the CPU; ``"gloo"``
    on the card runs gloo's collectives over CUDA tensors. ``rank`` /
    ``world_size`` default to the launch environment; ``init_method`` to
    ``tcp://`` + ``PADDLE_MASTER`` when the world has more than one rank.
    ``timeout`` (a ``datetime.timedelta``) bounds every collective's wait,
    as ``init_process_group``'s."""
    global _default_group, _device, _exit_hook
    if is_initialized():
        return _default_group
    if _env.initialized:  # the world was torn down under this module
        destroy_process_group()
    dev = resolve_device(device)
    if backend is not None and backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' serves CUDA devices only")
    if dist.is_initialized():
        running = dist.get_backend()
        if backend is not None and running != backend:
            raise ValueError(f"the running {running} world is not the "
                             f"{backend} world asked for")
        # a running gloo world serves either device (its collectives take
        # CUDA tensors too); an NCCL one only the card
        if running == "nccl" and dev.type != "cuda":
            raise ValueError(f"the running {running} world does not serve "
                             f"device {dev}")
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = _env.rank if rank is None else int(rank)
        world_size = _env.world_size if world_size is None else int(
            world_size)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if init_method is None and world_size > 1:
            if not _env.master:
                raise ValueError("a world of more than one rank needs "
                                 "init_method or PADDLE_MASTER")
            init_method = f"tcp://{_env.master}"
        kw = {} if timeout is None else {"timeout": timeout}
        if init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size, **kw)
    if dev.type == "cuda":
        idx = _env.device_id if _env.device_id is not None else (
            rank % torch.cuda.device_count())
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    _env.rank, _env.world_size = rank, world_size
    _env.initialized = True
    _device = dev
    from .topology import Group

    _default_group = Group(list(range(world_size)), axis_name=None,
                           rank=rank, process_group=dist.group.WORLD)
    if not _exit_hook:
        atexit.register(_release_at_exit)
        _exit_hook = True
    return _default_group


def _release_at_exit():
    """End the world and free its groups while gloo's threads can still
    take the interpreter lock (see the module doc); a cycle that holds a
    group goes with the collection."""
    destroy_process_group()
    gc.collect()


def get_device() -> torch.device:
    """The device this rank's world serves (initialising the world on the
    card when it is not running yet)."""
    if not is_initialized():
        init_parallel_env()
    return _device


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    return _env.rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return _env.world_size


def is_initialized() -> bool:
    return _env.initialized and dist.is_initialized()


def destroy_process_group():
    """Tear the world down and forget it: the default group, the global
    mesh and ``fleet``'s topology go with it, and the next
    :func:`init_parallel_env` (or ``fleet.init``) starts a new world."""
    global _default_group, _global_mesh, _device
    from .fleet.fleet_base import fleet_state

    if dist.is_initialized():
        dist.destroy_process_group()
    _subgroups.clear()
    _env.__init__()
    _default_group = _global_mesh = _device = None
    fleet_state.__init__()


def new_group(ranks: Optional[List[int]] = None, backend=None, timeout=None):
    """A group over ``ranks`` (every rank of the world must call this, in
    the same order, as ``torch.distributed.new_group`` requires)."""
    from .topology import Group

    if not is_initialized():
        init_parallel_env()
    ranks = list(ranks) if ranks is not None else list(range(_env.world_size))
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    rank = ranks.index(_env.rank) if _env.rank in ranks else -1
    return Group(ranks, axis_name=None, rank=rank, process_group=pg)


def subgroup(ranks: List[int]):
    """The group over global ``ranks`` that only its members make (every
    member calls this with the same ranks, in the same order as its other
    ``subgroup`` calls; a rank outside ``ranks`` gets None and takes no
    part). The process keeps it: a later call with the same ranks returns
    the same group. The whole world is the world's group."""
    from .topology import Group

    if not is_initialized():
        init_parallel_env()
    ranks = [int(r) for r in ranks]
    if _env.rank not in ranks:
        return None
    if ranks == list(range(_env.world_size)):
        return Group(ranks, axis_name=None, rank=_env.rank,
                     process_group=dist.group.WORLD)
    g = _subgroups.get(tuple(ranks))
    if g is None:
        pg = dist.new_group(ranks, use_local_synchronization=True)
        g = _subgroups[tuple(ranks)] = Group(
            ranks, axis_name=None, rank=ranks.index(_env.rank),
            process_group=pg)
    return g


def get_group(gid=None):
    return _default_group


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def current_mesh():
    """:func:`get_mesh` while a world runs, else the mesh :func:`set_mesh`
    left (None when none): never starts a world."""
    return get_mesh() if is_initialized() else _global_mesh


def get_mesh():
    """The global mesh: the one ``fleet.init`` or :func:`set_mesh` set, else
    the hybrid mesh with every rank on ``dp`` (the reference's default)."""
    global _global_mesh
    if not is_initialized():
        init_parallel_env()  # a torn-down world's mesh goes with it
    if _global_mesh is None:
        from .topology import build_mesh

        _global_mesh = build_mesh(dp=_env.world_size)
    return _global_mesh


# ------------------------------------------------------------ DataParallel
def buckets(tensors, bucket_mb: float = 25):
    """``tensors`` in order, cut into runs of one dtype and device whose
    bytes stay within ``bucket_mb`` MB (a tensor larger than that is a
    bucket of its own)."""
    limit = max(1, int(bucket_mb * 2 ** 20))
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (size + nbytes > limit or t.dtype != cur[0].dtype
                    or t.device != cur[0].device):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def allreduce_buckets(tensors, group=None, op="avg",
                      bucket_mb: float = 25) -> int:
    """All-reduce ``tensors`` in place over ``group`` (None: the world),
    one call a bucket (:func:`buckets`); ``op`` ``"avg"`` divides the sum
    by the group's size, ``"sum"`` keeps it. Every member passes tensors
    of the same shapes in the same order. Returns the number of calls."""
    from .collective import ReduceOp, all_reduce

    n = (group.nranks if group is not None else get_world_size())
    tensors = [t for t in tensors if t is not None]
    if n <= 1 or not tensors:
        return 0
    calls = 0
    for bucket in buckets(tensors, bucket_mb):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            flat = bucket[0].view(-1)
        else:
            flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce(flat, op=ReduceOp.SUM, group=group)
        if op == "avg":
            flat.div_(n)
        if flat.data_ptr() != bucket[0].data_ptr():
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        calls += 1
    return calls


def is_expert_parallel(p) -> bool:
    """Whether ``p`` is an expert parameter of an ep > 1 ``MoELayer``."""
    group = getattr(p, "expert_group", None)
    return group is not None and group.nranks > 1


@torch.no_grad()
def sync_gradients(params, group=None, bucket_mb: float = 25) -> int:
    """Average the gradients of ``params`` over ``group`` (None: the world)
    in buckets, leaving the expert-parallel ones out (see the module doc):
    those are divided by their expert group's size. Returns the number of
    all-reduce calls."""
    grads = []
    for p in params:
        g = getattr(p, "grad", None)
        if g is None:
            continue
        if is_expert_parallel(p):
            g.div_(p.expert_group.nranks)
        else:
            grads.append(g)
    return allreduce_buckets(grads, group, "avg", bucket_mb)


class DataParallel(torch.nn.Module):
    """Data-parallel wrapper (after ``paddle_tpu/distributed/parallel.py``
    ``DataParallel``): ``model(x)`` runs the wrapped layers; after the
    backward, :meth:`apply_collective_grads` averages the gradients over
    ``group`` (None: the world) in buckets of ``comm_buffer_size`` MB, and
    inside :meth:`no_sync` it does nothing, so gradients accumulate
    unsynchronised until the first call outside it. Nothing is reduced
    automatically. At wrap, the group's first rank broadcasts every
    parameter and buffer, so the replicas start equal. The ``Layer``
    surface (``state_dict``, ``named_parameters``, ...) is the wrapped
    model's, under its own names."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        if not is_initialized():
            init_parallel_env()
        self._layers = layers
        self._group = group
        self._sync = True
        self.comm_buffer_size = comm_buffer_size
        self.last_buckets = 0
        self._broadcast_state()

    @torch.no_grad()
    def _broadcast_state(self):
        from .collective import broadcast

        g = self._group
        if (g.nranks if g is not None else get_world_size()) <= 1:
            return
        src = g.ranks[0] if g is not None else 0
        for t in [p for p in self._layers.parameters()
                  if not is_expert_parallel(p)] + list(
                self._layers.buffers()):
            broadcast(t.data, src, group=g)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def apply_collective_grads(self):
        """Average the gradients over the group (those that are None stay
        None: every member must agree on which parameters have one); the
        expert-parallel ones are divided by their group's size instead
        (:func:`sync_gradients`)."""
        if not self._sync:
            return
        self.last_buckets = sync_gradients(
            self._layers.parameters(), self._group, self.comm_buffer_size)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__") or name == "_layers":
                raise
            return getattr(self._modules["_layers"], name)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict
