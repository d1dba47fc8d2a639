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
it.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "destroy_process_group", "new_group",
           "subgroup", "get_group", "set_mesh", "get_mesh", "current_mesh",
           "get_device"]


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
    global _default_group, _device
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
    return _default_group


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
