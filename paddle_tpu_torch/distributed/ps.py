"""Parameter-server training mode (after ``paddle_tpu/distributed/ps.py``;
upstream ``paddle/fluid/distributed/ps/``: dense and sparse tables behind
brpc, surfaced through fleet's PS mode for recommender models).

The reference package's design, over the port's own RPC layer
(:mod:`.rpc`):

* **Dense tables**: named f32 tensors with a server-side update; workers
  ``pull_dense`` / ``push_dense`` whole tensors.
* **Sparse tables**: embeddings whose rows are made on first touch
  (upstream's ctr accessor): ``pull_sparse(ids)`` gathers rows,
  ``push_sparse(ids, grads)`` updates them row by row; duplicate ids in one
  push apply in turn.
* **Async by default**: each push applies at once (upstream's async SGD);
  ``barrier()`` waits for this worker's pushes, the edge of a sync step.

Tables are CPU ``torch.float32`` tensors: host memory by design, as the
reference's numpy tables are (a server holds what no card could). A new
sparse row is drawn from one numpy generator seeded 0, ``N(0, 1) * 0.01``,
as the reference draws it, so the same pushes give the same tables in
both packages.

Roles follow upstream's environment contract, ``PADDLE_TRAINING_ROLE``
(``PSERVER`` / ``TRAINER``), an explicit ``role`` taking precedence.
Server optimizers: sgd, adagrad, adam, and geo (the deltas of
:class:`GeoTrainer`'s ``k_steps`` local training, summed).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from . import rpc

__all__ = ["ParameterServer", "init_ps", "pull_dense", "push_dense",
           "pull_sparse", "push_sparse", "register_dense", "barrier",
           "shutdown", "is_server", "is_worker", "server_name",
           "GeoTrainer"]

_EPS = 1e-8


def _f32(x) -> torch.Tensor:
    """``x`` (a tensor, an array or a list) as a CPU f32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _ids(ids):
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, np.int64).reshape(-1)


class ParameterServer:
    """Server-side state: dense and sparse tables and their optimizer."""

    def __init__(self, lr: float = 0.01, optimizer: str = "sgd",
                 sparse_dim: int = 8, initializer=None,
                 beta1: float = 0.9, beta2: float = 0.999):
        if optimizer not in ("sgd", "adagrad", "adam", "geo"):
            raise ValueError(
                "ParameterServer optimizer: sgd | adagrad | adam | geo")
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self._adam_step: Dict = {}
        self.lr = float(lr)
        self.optimizer = optimizer
        self.sparse_dim = int(sparse_dim)
        # one generator for the server's lifetime: re-seeding per row would
        # make every embedding row the same
        self._init_rng = np.random.default_rng(0)
        self.initializer = initializer or (
            lambda shape: self._init_rng.standard_normal(shape).astype(
                np.float32) * 0.01)
        self._dense: Dict[str, torch.Tensor] = {}
        self._dense_acc: Dict[str, torch.Tensor] = {}
        self._sparse: Dict[str, Dict[int, torch.Tensor]] = {}
        self._sparse_acc: Dict[str, Dict[int, torch.Tensor]] = {}
        self._mu = threading.Lock()

    def _update(self, p, g, acc, key):
        """Apply gradient (or geo delta) ``g`` to ``p`` in place; ``acc()``
        makes the optimizer state of ``key`` on first use."""
        if self.optimizer == "geo":
            p += g  # the delta already carries the worker's local lr
        elif self.optimizer == "adagrad":
            a = acc(1)
            a += g * g
            p -= self.lr * g / (torch.sqrt(a) + _EPS)
        elif self.optimizer == "adam":
            mv = acc(2)
            t = self._adam_step.get(key, 0) + 1
            self._adam_step[key] = t
            mv[0] = self.beta1 * mv[0] + (1 - self.beta1) * g
            mv[1] = self.beta2 * mv[1] + (1 - self.beta2) * g * g
            mh = mv[0] / (1 - self.beta1 ** t)
            vh = mv[1] / (1 - self.beta2 ** t)
            p -= self.lr * mh / (torch.sqrt(vh) + _EPS)
        else:
            p -= self.lr * g

    # ---------------------------------------------------------- dense
    def register_dense(self, name: str, value):
        with self._mu:
            if name not in self._dense:  # first registration wins
                self._dense[name] = _f32(value).clone()
        return True

    def pull_dense(self, name: str) -> torch.Tensor:
        with self._mu:
            return self._dense[name].clone()

    def push_dense(self, name: str, grad):
        """Apply a worker's dense update: a gradient for sgd / adagrad /
        adam; for ``geo`` a parameter delta from local training, summed."""
        g = _f32(grad)
        with self._mu:
            p = self._dense[name]

            def acc(n):
                if name not in self._dense_acc:
                    self._dense_acc[name] = torch.zeros((n,) + p.shape)
                st = self._dense_acc[name]
                return st[0] if n == 1 else st

            self._update(p, g, acc, name)
        return True

    # --------------------------------------------------------- sparse
    def _row(self, table: str, i: int) -> torch.Tensor:
        rows = self._sparse.setdefault(table, {})
        if i not in rows:  # made on first touch (ctr accessor)
            rows[i] = _f32(self.initializer((self.sparse_dim,))).clone()
        return rows[i]

    def pull_sparse(self, table: str, ids) -> torch.Tensor:
        ids = _ids(ids)
        with self._mu:
            return torch.stack([self._row(table, int(i)).clone()
                                for i in ids])

    def push_sparse(self, table: str, ids, grads):
        ids = _ids(ids)
        grads = _f32(grads).reshape(len(ids), -1)
        with self._mu:
            acc_tab = self._sparse_acc.setdefault(table, {})
            for i, g in zip(ids, grads):
                i = int(i)
                row = self._row(table, i)

                def acc(n, i=i, row=row):
                    if i not in acc_tab:
                        acc_tab[i] = torch.zeros((n,) + row.shape)
                    st = acc_tab[i]
                    return st[0] if n == 1 else st

                self._update(row, g, acc, (table, i))
        return True

    def stats(self):
        with self._mu:
            return {"dense": sorted(self._dense),
                    "sparse_rows": {t: len(r)
                                    for t, r in self._sparse.items()}}


# -------------------------------------------------- module-level service
# RPC ships (fn, args) by reference to importable functions; these shims
# over the process-global server are the surface a PSERVER exposes.

_SERVER: Optional[ParameterServer] = None
_ROLE = {"role": None, "server": "ps0"}


def _srv() -> ParameterServer:
    if _SERVER is None:
        raise RuntimeError("this process is not a parameter server")
    return _SERVER


def _rpc_register_dense(name, value):
    return _srv().register_dense(name, value)


def _rpc_pull_dense(name):
    return _srv().pull_dense(name)


def _rpc_push_dense(name, grad):
    return _srv().push_dense(name, grad)


def _rpc_pull_sparse(table, ids):
    return _srv().pull_sparse(table, ids)


def _rpc_push_sparse(table, ids, grads):
    return _srv().push_sparse(table, ids, grads)


def _rpc_stats():
    return _srv().stats()


# ------------------------------------------------------------ client API


def init_ps(name: str, rank: int, world_size: int,
            master_endpoint: str = "127.0.0.1:29600", role: str = None,
            server_name: str = "ps0", **server_kw):
    """Join a PS world: one PSERVER (named ``server_name``) and trainers.
    ``role`` defaults to ``PADDLE_TRAINING_ROLE``."""
    global _SERVER
    role = (role or os.environ.get("PADDLE_TRAINING_ROLE", "TRAINER")
            ).upper()
    if role not in ("PSERVER", "TRAINER"):
        raise ValueError(f"bad PS role {role!r}")
    if role == "PSERVER":
        _SERVER = ParameterServer(**server_kw)
    _ROLE["role"] = role
    _ROLE["server"] = server_name
    rpc.init_rpc(name, rank, world_size, master_endpoint)
    return _ROLE["role"]


def is_server() -> bool:
    return _ROLE["role"] == "PSERVER"


def is_worker() -> bool:
    return _ROLE["role"] == "TRAINER"


def server_name() -> str:
    return _ROLE["server"]


def register_dense(name: str, value):
    return rpc.rpc_sync(_ROLE["server"], _rpc_register_dense,
                        (name, _f32(value)))


def pull_dense(name: str) -> torch.Tensor:
    return rpc.rpc_sync(_ROLE["server"], _rpc_pull_dense, (name,))


_PENDING = []
_PENDING_MU = threading.Lock()


def _track(fut):
    with _PENDING_MU:
        _PENDING.append(fut)
        if len(_PENDING) > 256:  # drop the finished ones now and then
            _PENDING[:] = [f for f in _PENDING if not f.done()]
    return fut


def push_dense(name: str, grad, sync: bool = False):
    g = _f32(grad)
    if sync:
        return rpc.rpc_sync(_ROLE["server"], _rpc_push_dense, (name, g))
    return _track(rpc.rpc_async(_ROLE["server"], _rpc_push_dense,
                                (name, g)))


def pull_sparse(table: str, ids) -> torch.Tensor:
    return rpc.rpc_sync(_ROLE["server"], _rpc_pull_sparse,
                        (table, _ids(ids)))


def push_sparse(table: str, ids, grads, sync: bool = False):
    a = (_ids(ids), _f32(grads))
    if sync:
        return rpc.rpc_sync(_ROLE["server"], _rpc_push_sparse,
                            (table,) + a)
    return _track(rpc.rpc_async(_ROLE["server"], _rpc_push_sparse,
                                (table,) + a))


def barrier():
    """Sync-mode edge: wait until THIS worker's async pushes are applied
    on the server (they ride connections of their own, so the fence is
    their futures). Returns the server's stats."""
    with _PENDING_MU:
        pending, _PENDING[:] = list(_PENDING), []
    for f in pending:
        f.result(timeout=120)
    return rpc.rpc_sync(_ROLE["server"], _rpc_stats, ())


def shutdown(graceful: bool = True):
    global _SERVER
    rpc.shutdown(graceful)
    _SERVER = None
    _ROLE["role"] = None


class GeoTrainer:
    """Worker-side geo-SGD (upstream fleet's a_sync ``geo`` mode with
    ``k_steps``). Train LOCALLY with any optimizer; every ``k_steps`` calls
    of :meth:`maybe_sync` push each parameter's DELTA since the last sync
    (the server, built with ``optimizer="geo"``, sums every trainer's) and
    pull the merged value back into the model. ``model`` is a port
    ``nn.Layer`` (any ``torch.nn.Module``).

    ``push`` / ``pull`` / ``register`` default to the module's RPC
    functions; pass a server's methods to run in one process."""

    def __init__(self, model, k_steps: int = 8, push=None, pull=None,
                 register=None):
        self.model = model
        self.k_steps = int(k_steps)
        self._push = push if push is not None else push_dense
        self._pull = pull if pull is not None else pull_dense
        self._register = (register if register is not None
                          else register_dense)
        self._count = 0
        self._snap = {}
        for n, p in model.named_parameters():
            cur = _f32(p)
            self._register(n, cur)
            self._snap[n] = cur.clone()

    @torch.no_grad()
    def maybe_sync(self) -> bool:
        """Call once a local optimizer step; pushes and pulls every
        ``k_steps``. Returns True when a sync happened."""
        self._count += 1
        if self._count % self.k_steps:
            return False
        for n, p in self.model.named_parameters():
            self._push(n, _f32(p) - self._snap[n])
        for n, p in self.model.named_parameters():
            merged = _f32(self._pull(n))
            p.copy_(merged.to(p.device, p.dtype))
            self._snap[n] = merged
        return True
