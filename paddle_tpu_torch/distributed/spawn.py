"""``paddle.distributed.spawn`` (after ``paddle_tpu/distributed/spawn.py``;
upstream ``python/paddle/distributed/spawn.py``).

Starts ``nprocs`` worker processes running ``func(*args)`` through
``torch.multiprocessing`` (the ``spawn`` start method: a CUDA context does
not survive a fork), each with the launch environment contract of
:func:`~.launch.controllers.build_env` set, so ``init_parallel_env()``
inside ``func`` finds its rank, the world size and the rendezvous. With
``join`` it waits for them and re-raises the first failure (torch's
``ProcessRaisedException`` carries the worker's traceback); without, it
returns the context, whose ``.processes`` are the workers. ``func`` must be
importable by the workers (a module-level function), as upstream's.
"""
from __future__ import annotations

import os
import socket
from typing import Sequence

__all__ = ["spawn"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, func, args, world_size, endpoints):
    from . import parallel
    from .launch.controllers import build_env

    os.environ.update(build_env(rank, world_size, endpoints, base_env={}))
    # this process imported parallel.py (to unpickle ``func``) before the
    # contract was set: read it again
    if not parallel.is_initialized():
        parallel._env.__init__()
    func(*args)


def spawn(func, args: Sequence = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """The reference's signature; ``options`` are accepted and unused, as
    there."""
    import torch.multiprocessing as mp

    if nprocs <= 0:
        nprocs = 1
    port = _free_port()
    endpoints = [f"127.0.0.1:{port + i}" for i in range(nprocs)]
    ctx = mp.start_processes(_worker, args=(func, tuple(args), nprocs,
                                            endpoints),
                             nprocs=nprocs, join=False, daemon=daemon,
                             start_method="spawn")
    if join:
        while not ctx.join():
            pass
    return ctx
