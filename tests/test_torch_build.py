"""``paddle_tpu_torch.kernels.build.load`` is thread-safe: threads that ask
for one kernel library at once start one build and share one library
(the serving front end's engine thread can race the main thread to a
kernel's first launch). The build and the ``ctypes`` load are stubbed: the
CPU has no ``nvcc``."""
import sys
import threading
import time

import pytest

from paddle_tpu_torch.kernels import build


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.paged_decode_attention = _FakeFn()
        self.quant_matmul = _FakeFn()


@pytest.fixture
def stubbed(monkeypatch):
    calls = {"start": [], "finish": 0}
    built = set()

    def start(name):
        # as the real one: no nvcc once the library is on disk
        if name in built:
            return None
        calls["start"].append(name)
        time.sleep(0.2)  # a slow nvcc: the race window
        return name

    def finish(proc):
        if proc is not None:
            calls["finish"] += 1
            built.add(proc)

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_start", start)
    monkeypatch.setattr(build, "_finish", finish)
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    return calls


@pytest.mark.parametrize("threads", [2, 8])
def test_racing_loads_build_once(stubbed, threads):
    gate = threading.Barrier(threads)
    got = [None] * threads

    def worker(i):
        gate.wait(timeout=30)
        got[i] = build.load("paged_decode_attention")

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert stubbed["start"] == ["paged_decode_attention"]
    assert stubbed["finish"] == 1
    assert all(lib is got[0] for lib in got) and got[0] is not None
    fn = got[0].paged_decode_attention
    assert fn.argtypes == build._SIGNATURES["paged_decode_attention"]


def test_build_all_and_load_race_builds_each_once(stubbed):
    names = ["paged_decode_attention", "quant_matmul"]
    box = {}
    t = threading.Thread(
        target=lambda: box.update(lib=build.load("quant_matmul")))
    t.start()
    build.build_all(names)
    t.join(timeout=30)
    assert not t.is_alive()
    assert sorted(stubbed["start"]) == sorted(names)
    assert box["lib"] is build._LIBS["quant_matmul"]
