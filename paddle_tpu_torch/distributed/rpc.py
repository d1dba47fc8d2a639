"""``paddle.distributed.rpc`` (after ``paddle_tpu/distributed/rpc.py``):
Python-level point-to-point RPC.

Upstream's capability is ``paddle/fluid/distributed/rpc/``
(``rpc_agent.cc`` over brpc), surfaced as ``init_rpc``, ``rpc_sync``,
``rpc_async``, ``get_worker_info``, ``get_all_worker_infos`` and
``shutdown``. The design is the reference package's, so the two
interoperate on the wire:

* the rendezvous goes through the port's own :class:`~.store.TCPStore`
  (rank 0 hosts it at ``master_endpoint``): each agent publishes
  ``name -> (host, port)`` under ``rpc/{rank}`` and reads every other's;
* each agent runs a threaded TCP server; a call is a length-prefixed
  pickle of ``(fn, args, kwargs)`` run in the receiving process, and the
  result (or the raised exception) travels back the same way. Callables
  must be importable at the callee (module-level functions).

``torch.distributed.rpc`` is not used: its rendezvous and wire format are
other ones.

Trust model, as upstream's brpc agent: this speaks pickle over the
training cluster's private interconnect, so do not expose the port beyond
it.
"""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

from .store import TCPStore

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]


@dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int
    ip: str
    port: int


class _Agent:
    def __init__(self):
        self.name = None
        self.rank = None
        self.world_size = None
        self.workers: Dict[str, WorkerInfo] = {}
        self.server: Optional[socketserver.ThreadingTCPServer] = None
        self.server_thread = None
        self.pool = None
        self.store = None


_agent = _Agent()
_lock = threading.Lock()


def _send_msg(sock, payload: bytes):
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock) -> bytes:
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed mid-message")
        buf += chunk
    return bytes(buf)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            fn, args, kwargs = pickle.loads(_recv_msg(self.request))
            try:
                result = ("ok", fn(*args, **(kwargs or {})))
            except Exception as e:  # ship the callee's exception back
                result = ("err", e)
            try:
                payload = pickle.dumps(result)
            except Exception as e:
                # unpicklable return/exception: tell the caller WHAT
                # happened instead of dropping the connection
                payload = pickle.dumps(("err", RuntimeError(
                    f"rpc callee result not picklable "
                    f"({type(result[1]).__name__}): {e}")))
            _send_msg(self.request, payload)
        except (ConnectionError, OSError):
            pass


def init_rpc(name: str, rank: int, world_size: int,
             master_endpoint: str = "127.0.0.1:29500",
             bind_address: Optional[str] = None):
    """Join the RPC world. ``master_endpoint`` hosts the rendezvous store
    (rank 0 starts it).

    The agent's server binds to ``bind_address`` when given; otherwise it
    binds to the interface it advertises (loopback for a local-master run,
    the host's resolved IP otherwise) — never to all interfaces, since the
    handler executes pickled payloads and must only be reachable over the
    cluster interconnect the trust model covers.
    """
    with _lock:
        if _agent.server is not None:
            raise RuntimeError("init_rpc called twice")
        host, port_s = master_endpoint.rsplit(":", 1)
        store = TCPStore(host, int(port_s), is_master=(rank == 0),
                         world_size=world_size)
        try:
            if bind_address:
                my_ip = bind_address
            elif host in ("127.0.0.1", "localhost"):
                my_ip = "127.0.0.1"
            else:
                my_ip = socket.gethostbyname(socket.gethostname())
            server = socketserver.ThreadingTCPServer(
                (my_ip, 0), _Handler, bind_and_activate=True)
        except Exception:
            # hostname resolution or bind can fail (gaierror, an
            # EADDRNOTAVAIL bind_address): don't leak the rendezvous
            # store — rank 0 holds the master listener on the endpoint
            # port and a corrected retry would hit EADDRINUSE
            try:
                store.close()
            except Exception:
                pass
            raise
        server.daemon_threads = True
        my_port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            store.set(f"rpc/{rank}",
                      pickle.dumps(WorkerInfo(name, rank, my_ip, my_port)))
            workers = {}
            for r in range(world_size):
                info = pickle.loads(
                    bytes(store.get(f"rpc/{r}", timeout=60)))
                workers[info.name] = info
        except Exception:
            # rendezvous failed (a peer never joined): release the bound
            # socket + thread so a retry doesn't leak one per attempt
            server.shutdown()
            server.server_close()
            try:
                store.close()
            except Exception:
                pass
            raise
        _agent.name, _agent.rank = name, rank
        _agent.world_size = world_size
        _agent.workers = workers
        _agent.server, _agent.server_thread = server, t
        _agent.pool = ThreadPoolExecutor(max_workers=16)
        _agent.store = store
    return get_worker_info()


def get_worker_info(name: Optional[str] = None) -> WorkerInfo:
    if _agent.server is None:
        raise RuntimeError("rpc not initialized")
    if name is None:
        name = _agent.name
    try:
        return _agent.workers[name]
    except KeyError:
        raise ValueError(f"unknown rpc worker {name!r}") from None


def get_all_worker_infos():
    if _agent.server is None:
        raise RuntimeError("rpc not initialized")
    return sorted(_agent.workers.values(), key=lambda w: w.rank)


def _call(to: str, fn, args, kwargs, timeout):
    info = get_worker_info(to)
    with socket.create_connection((info.ip, info.port),
                                  timeout=timeout or 120.0) as sock:
        _send_msg(sock, pickle.dumps((fn, args, kwargs)))
        status, payload = pickle.loads(_recv_msg(sock))
    if status == "err":
        raise payload
    return payload


def rpc_sync(to: str, fn, args=(), kwargs=None, timeout=None):
    """Execute ``fn(*args, **kwargs)`` on worker ``to``, block for the
    result (reference: paddle.distributed.rpc.rpc_sync)."""
    return _call(to, fn, tuple(args), kwargs, timeout)


def rpc_async(to: str, fn, args=(), kwargs=None, timeout=None) -> Future:
    """Like rpc_sync but returns a Future (reference: rpc_async; .wait()
    maps to .result())."""
    if _agent.server is None:
        raise RuntimeError("rpc not initialized")
    fut = _agent.pool.submit(_call, to, fn, tuple(args), kwargs, timeout)
    fut.wait = fut.result  # paddle's FutureWrapper API
    return fut


def shutdown(graceful: bool = True):
    """Leave the RPC world. ``graceful`` barriers on all workers having
    called shutdown, so no peer's pending rpc_sync loses its callee."""
    with _lock:
        if _agent.server is None:
            return
        if graceful:
            try:
                _agent.store.add("rpc/shutdown", 1)
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    if int(_agent.store.add("rpc/shutdown", 0)
                           ) >= _agent.world_size:
                        break
                    time.sleep(0.05)
            except Exception:
                pass
        _agent.server.shutdown()
        _agent.server.server_close()
        _agent.pool.shutdown(wait=False)
        try:
            _agent.store.close()
        except Exception:
            pass
        _agent.__init__()
