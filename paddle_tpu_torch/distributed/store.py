"""TCPStore, the rendezvous key-value store (after
``paddle_tpu/distributed/store.py``; upstream
``paddle/fluid/distributed/store/tcp_store.cc`` and
``paddle.distributed.TCPStore``).

Two backends: the native C++ server and client (``native/tcp_store.cc``,
one thread per connection, blocking GET on a condition variable), built
with g++ at first use; and a pure-Python server and client. Both speak the
reference package's wire protocol, so a client of either backend, or of
either package, talks to a server of either. ``use_native=None`` takes the
native store when it builds, else the Python one; ``True`` raises when it
does not build; ``False`` takes the Python one.

``TCPStore(host, port, is_master, world_size, timeout, use_native)`` with
``set`` / ``get`` / ``add`` / ``check`` / ``delete_key`` / ``wait`` /
``barrier`` (barrier = an add on a counter key, then a blocking get of the
release key, the reference's scheme). A host process by design: it keeps
its keys in host memory and needs no device.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Optional

__all__ = ["TCPStore"]


# ------------------------------------------------------- python fallback ---


class _PyStoreServer:
    """Pure-Python server speaking the native wire protocol."""

    def __init__(self, port: int):
        store = {}
        cond = threading.Condition()
        stopping = threading.Event()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        hdr = self._read(sock, 5)
                        if hdr is None:
                            return
                        op, klen = struct.unpack("<BI", hdr)
                        key = self._read(sock, klen).decode()
                        (vlen,) = struct.unpack("<I", self._read(sock, 4))
                        val = self._read(sock, vlen) if vlen else b""
                        status, out = self._dispatch(op, key, val)
                        sock.sendall(struct.pack("<qI", status, len(out)) + out)
                except (ConnectionError, TypeError, struct.error):
                    return

            @staticmethod
            def _read(sock, n):
                buf = b""
                while len(buf) < n:
                    chunk = sock.recv(n - len(buf))
                    if not chunk:
                        return None
                    buf += chunk
                return buf

            def _dispatch(self, op, key, val):
                if op == 0:  # SET
                    with cond:
                        store[key] = val
                        cond.notify_all()
                    return 0, b""
                if op == 1:  # GET (blocking)
                    (timeout_ms,) = struct.unpack("<q", val)
                    deadline = (None if timeout_ms < 0
                                else time.monotonic() + timeout_ms / 1e3)
                    with cond:
                        while key not in store and not stopping.is_set():
                            remaining = (None if deadline is None
                                         else deadline - time.monotonic())
                            if remaining is not None and remaining <= 0:
                                return -2, b""
                            cond.wait(remaining if remaining is not None
                                      else 1.0)
                        if key in store:
                            return 0, store[key]
                    return -1, b""
                if op == 2:  # ADD
                    (delta,) = struct.unpack("<q", val)
                    with cond:
                        cur = int(store.get(key, b"0").decode() or 0)
                        cur += delta
                        store[key] = str(cur).encode()
                        cond.notify_all()
                    return cur, b""
                if op == 3:
                    with cond:
                        return (1 if key in store else 0), b""
                if op == 4:
                    with cond:
                        return (1 if store.pop(key, None) is not None
                                else 0), b""
                return -100, b""

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("0.0.0.0", port), Handler)
        self._stopping = stopping
        self._cond = cond
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="tcpstore-py")
        self._thread.start()

    def stop(self):
        self._stopping.set()
        with self._cond:
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()


class _PyClient:
    def __init__(self, host: str, port: int, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        last = None
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout_s)
                break
            except OSError as e:
                last = e
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"TCPStore connect to {host}:{port} timed out"
                    ) from last
                time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._lock = threading.Lock()

    def _roundtrip(self, op: int, key: str, val: bytes):
        kb = key.encode()
        msg = struct.pack("<BI", op, len(kb)) + kb + struct.pack(
            "<I", len(val)) + val
        with self._lock:
            self._sock.sendall(msg)
            hdr = b""
            while len(hdr) < 12:
                chunk = self._sock.recv(12 - len(hdr))
                if not chunk:
                    raise ConnectionError("TCPStore server closed")
                hdr += chunk
            status, olen = struct.unpack("<qI", hdr)
            out = b""
            while len(out) < olen:
                chunk = self._sock.recv(olen - len(out))
                if not chunk:
                    raise ConnectionError(
                        "TCPStore server closed mid-response")
                out += chunk
        return status, out

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class _NativeClient:
    def __init__(self, lib, host: str, port: int, timeout_s: float):
        import ctypes

        self._lib = lib
        self._h = lib.ts_client_connect(host.encode(), port,
                                        int(timeout_s * 1000))
        if not self._h:
            raise TimeoutError(f"TCPStore connect to {host}:{port} failed")
        self._ctypes = ctypes
        self._lock = threading.Lock()

    def _roundtrip(self, op: int, key: str, val: bytes):
        ct = self._ctypes
        with self._lock:
            if op == 0:
                buf = (ct.c_uint8 * len(val)).from_buffer_copy(val) if val \
                    else None
                return self._lib.ts_set(self._h, key.encode(), buf,
                                        len(val)), b""
            if op == 1:
                (timeout_ms,) = struct.unpack("<q", val)
                cap = 1 << 20
                out = (ct.c_uint8 * cap)()
                olen = ct.c_uint32(0)
                status = self._lib.ts_get(self._h, key.encode(), timeout_ms,
                                          out, cap, ct.byref(olen))
                if status == -203:  # buffer too small: retry at actual size
                    cap = olen.value
                    out = (ct.c_uint8 * cap)()
                    status = self._lib.ts_get(self._h, key.encode(),
                                              timeout_ms, out, cap,
                                              ct.byref(olen))
                return status, bytes(out[: olen.value])
            if op == 2:
                (delta,) = struct.unpack("<q", val)
                return self._lib.ts_add(self._h, key.encode(), delta), b""
            if op == 3:
                return self._lib.ts_check(self._h, key.encode()), b""
            if op == 4:
                return self._lib.ts_delete(self._h, key.encode()), b""
        raise ValueError(op)

    def close(self):
        self._lib.ts_client_close(self._h)


# ----------------------------------------------------------------- facade ---


class TCPStore:
    """paddle.distributed.TCPStore parity over native-or-python backends."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6170,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0, use_native: Optional[bool] = None):
        self.host, self.port = host, port
        self.is_master = is_master
        self.world_size = world_size
        self._server = None
        self._server_native = None
        lib = None
        if use_native is not False:
            from ..native import tcp_store_lib

            lib = tcp_store_lib()
            if lib is None and use_native is True:
                raise RuntimeError("native TCPStore unavailable")
        self.backend = "native" if lib is not None else "python"
        if is_master:
            if lib is not None:
                self._server_native = (lib, lib.ts_server_start(port))
                if not self._server_native[1]:
                    raise OSError(f"TCPStore: cannot bind port {port}")
            else:
                self._server = _PyStoreServer(port)
        self._client = (_NativeClient(lib, host, port, timeout)
                        if lib is not None
                        else _PyClient(host, port, timeout))

    # ------------------------------------------------------------- KV API
    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()
        status, _ = self._client._roundtrip(0, key, bytes(value))
        if status < 0:
            raise RuntimeError(f"TCPStore.set failed ({status})")

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        tmo = -1 if timeout is None else int(timeout * 1000)
        status, out = self._client._roundtrip(
            1, key, struct.pack("<q", tmo))
        if status == -2:
            raise TimeoutError(f"TCPStore.get({key!r}) timed out")
        if status < 0:
            raise RuntimeError(f"TCPStore.get failed ({status})")
        return out

    def add(self, key: str, amount: int = 1) -> int:
        status, _ = self._client._roundtrip(
            2, key, struct.pack("<q", amount))
        if status < -99:
            raise RuntimeError(f"TCPStore.add failed ({status})")
        return int(status)

    def wait(self, key: str, timeout: Optional[float] = None):
        self.get(key, timeout)

    def check(self, key: str) -> bool:
        status, _ = self._client._roundtrip(3, key, b"")
        return status == 1

    def delete_key(self, key: str) -> bool:
        status, _ = self._client._roundtrip(4, key, b"")
        return status == 1

    def barrier(self, name: str = "default", timeout: float = 60.0):
        """All ``world_size`` participants block until everyone arrives
        (reference scheme: counter + release key). Reusable: each call on a
        name is a new epoch — participants make the same sequence of calls,
        so their local epoch counters agree."""
        epochs = self.__dict__.setdefault("_barrier_epochs", {})
        epoch = epochs.get(name, 0)
        epochs[name] = epoch + 1
        prefix = f"__barrier/{name}/{epoch}"
        arrived = self.add(f"{prefix}/count", 1)
        if arrived == self.world_size:
            self.set(f"{prefix}/release", b"1")
        self.get(f"{prefix}/release", timeout)

    def close(self):
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self._client.close()
        if self._server is not None:
            self._server.stop()
        if self._server_native is not None:
            lib, h = self._server_native
            lib.ts_server_stop(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
