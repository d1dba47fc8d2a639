"""The port's ``TCPStore`` (``distributed/store.py``) on both of its
backends, the native C++ store (``native/tcp_store.cc``, built with g++
into ``build/paddle_tpu_torch/`` at first use) and the pure-Python one, in
the reference's cases (``tests/test_tcp_store.py``); then across packages:
the wire protocol is the reference's, so a port client talks to the JAX
package's Python server and a JAX package client to the port's servers.
"""
import socket
import threading
import time

import pytest

from paddle_tpu_torch.distributed import TCPStore
from paddle_tpu_torch.native import tcp_store_lib


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_native_build():
    """The C++ store builds here (g++ is on the image), into the port's
    build directory."""
    lib = tcp_store_lib()
    assert lib is not None, "native tcp_store failed to compile"
    assert "build/paddle_tpu_torch" in lib._name


@pytest.mark.parametrize("native", [False, True])
class TestTCPStore:
    def test_set_get_add_check_delete(self, native):
        port = free_port()
        master = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                          use_native=native)
        try:
            assert master.backend == ("native" if native else "python")
            master.set("k", b"hello")
            assert master.get("k") == b"hello"
            assert master.check("k")
            assert master.add("ctr", 5) == 5
            assert master.add("ctr", 2) == 7
            assert master.get("ctr") == b"7"
            assert master.delete_key("k")
            assert not master.check("k")
            master.set("s", "text")  # str values are utf-8
            assert master.get("s") == b"text"
        finally:
            master.close()

    def test_blocking_get_across_clients(self, native):
        port = free_port()
        master = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                          use_native=native)
        client = TCPStore("127.0.0.1", port, is_master=False, world_size=1,
                          use_native=native)
        try:
            got = {}

            def getter():
                got["v"] = client.get("late", timeout=10)

            t = threading.Thread(target=getter)
            t.start()
            time.sleep(0.2)
            master.set("late", b"worth-the-wait")
            t.join(timeout=10)
            assert got["v"] == b"worth-the-wait"
            client.wait("late", timeout=1)
        finally:
            client.close()
            master.close()

    def test_get_timeout(self, native):
        port = free_port()
        master = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                          use_native=native)
        try:
            with pytest.raises(TimeoutError):
                master.get("never", timeout=0.2)
        finally:
            master.close()

    def test_barrier(self, native):
        port = free_port()
        master = TCPStore("127.0.0.1", port, is_master=True, world_size=3,
                          use_native=native)
        others = [TCPStore("127.0.0.1", port, world_size=3,
                           use_native=native) for _ in range(2)]
        try:
            done = []

            def arrive(store, delay):
                time.sleep(delay)
                store.barrier("b1", timeout=15)
                done.append(time.monotonic())

            threads = [threading.Thread(target=arrive, args=(s, d))
                       for s, d in [(master, 0.3), (others[0], 0.0),
                                    (others[1], 0.15)]]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=20)
            assert len(done) == 3
            # nobody released before the last arrival (~0.3 s)
            assert min(done) - t0 >= 0.28
        finally:
            for s in others:
                s.close()
            master.close()


def test_use_native_none_takes_the_native_store():
    port = free_port()
    master = TCPStore("127.0.0.1", port, is_master=True)
    try:
        assert master.backend == "native"
    finally:
        master.close()


def test_cross_backend_interop():
    """A Python client against the native server: one wire protocol."""
    port = free_port()
    master = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                      use_native=True)
    py_client = TCPStore("127.0.0.1", port, is_master=False, world_size=1,
                         use_native=False)
    try:
        py_client.set("x", b"from-python")
        assert master.get("x") == b"from-python"
        assert py_client.add("n", 3) == 3
        assert master.add("n", 4) == 7
    finally:
        py_client.close()
        master.close()


def _exchange(a, b):
    """Keys, counters and a blocking get between two stores' clients."""
    a.set("x", b"from-a")
    assert b.get("x") == b"from-a"
    assert b.add("n", 3) == 3
    assert a.add("n", 4) == 7
    assert a.check("x") and b.delete_key("x") and not a.check("x")
    got = {}
    t = threading.Thread(target=lambda: got.update(v=a.get("late",
                                                           timeout=10)))
    t.start()
    time.sleep(0.1)
    b.set("late", b"ok")
    t.join(timeout=10)
    assert got["v"] == b"ok"


@pytest.mark.parametrize("native", [False, True])
def test_port_client_against_the_reference_server(native):
    from paddle_tpu.distributed.store import TCPStore as JaxStore

    port = free_port()
    server = JaxStore("127.0.0.1", port, is_master=True, world_size=1,
                      use_native=False)
    client = TCPStore("127.0.0.1", port, world_size=1, use_native=native)
    try:
        _exchange(client, server)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("native", [False, True])
def test_reference_client_against_the_port_server(native):
    from paddle_tpu.distributed.store import TCPStore as JaxStore

    port = free_port()
    server = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                      use_native=native)
    client = JaxStore("127.0.0.1", port, world_size=1, use_native=False)
    try:
        _exchange(client, server)
    finally:
        client.close()
        server.close()
