"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/paddle_tpu_torch/<name>-<hash>.so

into ``build/paddle_tpu_torch/`` at the repository root (listed in
``.gitignore``), and loads through ``ctypes``: a plain C interface, no
PyTorch headers, so a build takes seconds. The file name carries a hash of
the sources and flags, so an edited source rebuilds and a stale library is
never loaded. :func:`build_all` starts one ``nvcc`` per source at once.

Host libraries (``paddle_tpu_torch/native/<name>.cc``, the TCP store)
build the same way with ``g++`` (:func:`build_host`), into the same
directory under a hashed name.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.

Thread safety: the first launch of a kernel may come from any thread (the
serving front end runs the engine on a thread of its own), so one lock
covers the check, the build and the ``ctypes`` load in :func:`load` and
:func:`build_all`: two threads never start two ``nvcc`` runs on one target.
Several engines may step on threads of their own in one process (the
in-process replicas of ``serving/router.py``): the launch counters are
bumped under one lock (:func:`count_launch`), and a thread capturing a
CUDA graph tallies its own launches apart (:func:`tally_launches`), so
another thread's launches during the capture are neither erased nor
taken for the graph's.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODES", "load",
           "build_all", "check", "stream_ptr", "build_seconds",
           "ptxas_report", "arrival_counters", "launch_counter",
           "LAUNCH_COUNTERS", "count_launch", "tally_launches",
           "add_launches", "HOST_FLAGS", "build_host"]

_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# argtypes of each library's C entry point (pointers and the stream as
# c_void_p, so ctypes never cuts a 64-bit address to 32 bits)
_SIGNATURES = {
    "paged_decode_attention": [_P] * 7 + [_I] * 8 + [_F, _I, _I]
    + [_P] * 4,
    "paged_decode_attention_v1": [_P] * 8 + [_I] * 7 + [_LL] * 2
    + [_I] * 2 + [_F, _I, _I] + [_P] * 4,
    "decode_attention": [_P] * 5 + [_I] * 5 + [_LL] * 5 + [_I] * 2
    + [_F, _I, _I] + [_P] * 4,
    "flash_attention_fwd": [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_I, _F, _I,
                                                               _P],
    "flash_attention_bwd": [_P] * 13 + [_I] * 5 + [_P, _I, _F, _I, _P],
    "paged_verify_attention": [_P] * 9 + [_I] * 7 + [_LL] * 3 + [_I] * 2
    + [_F] + [_I] * 3 + [_P],
    "quant_matmul": [_P] * 7 + [_I] * 8 + [_P],
    "grouped_matmul": [_P] * 5 + [_I] * 6 + [_P],
}

HOST_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
# held over the check, the build and the load (re-entrant: build_all loads)
_LOCK = threading.RLock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._ptt = (name, tmp, out, log, time.perf_counter())  # type: ignore
    return proc


def _finish(proc: Optional[subprocess.Popen]):
    if proc is None:
        return
    name, tmp, out, log, t0 = proc._ptt  # type: ignore
    rc = proc.wait()
    log.close()
    build_seconds[name] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n"
                           + out.with_suffix(".log").read_text()[-4000:])
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every kernel library (one nvcc per source, all started
    together) and return the seconds each build took (0 when cached)."""
    names = list(names or _SIGNATURES)
    with _LOCK:
        procs = [_start(n) for n in names if n not in _LIBS]
        for p in procs:
            _finish(p)
        for n in names:
            build_seconds.setdefault(n, 0.0)
            load(n)
        return {n: build_seconds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (once,
    whichever threads ask at the same time)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if name not in _SIGNATURES:
                raise KeyError(f"unknown kernel library {name!r}")
            _finish(_start(name))
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def build_host(source: Path) -> Optional[Path]:
    """The shared library of the host C++ file ``source`` (g++
    ``HOST_FLAGS``), built on first use into ``BUILD_DIR`` under a name
    that carries a hash of the source and the flags; None when there is no
    ``g++`` or the build fails (the caller falls back or raises). A build
    writes a file of its own and renames it into place, so processes that
    build at once never load half a library."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    out = BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"
    with _LOCK:
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            r = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp),
                                str(source)], capture_output=True,
                               text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
        return out


def ptxas_report(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) of the last build
    of ``name`` ("" when the library came from an earlier build)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        meaning = _CUDA_ERRORS.get(rc, "see cudaError_t")
        raise RuntimeError(f"{what}: CUDA error {rc} ({meaning})")


_CUDA_ERRORS = {1: "invalid value: a shape, dtype or head_dim the kernel "
                   "does not take", 2: "out of memory",
                9: "invalid configuration", 98: "invalid device function",
                209: "no kernel image for this device",
                700: "illegal address"}


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# (wrapper, attribute) of every kernel launch counter, registered where the
# wrapper is defined: a CUDA graph's replay calls no wrapper, so the
# runner adds each counter's delta over the capture on every replay
LAUNCH_COUNTERS: List[tuple] = []


def launch_counter(fn, *attrs: str):
    """Give wrapper ``fn`` the launch counters ``attrs`` (each starting at
    0) and register them in :data:`LAUNCH_COUNTERS`."""
    for attr in attrs:
        setattr(fn, attr, 0)
        LAUNCH_COUNTERS.append((fn, attr))


# every read-modify-write of a counter holds this lock; a capturing
# thread's launches go to its own tally instead (``_TALLY.d``)
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count_launch(fn, *attrs: str):
    """Count one launch of ``fn``'s kernel on each counter in ``attrs``
    (``"launches"`` when none is given). Inside :func:`tally_launches` on
    this thread the launch was recorded into a graph, not run: it goes to
    the tally and the counters stay as they were."""
    attrs = attrs or ("launches",)
    tally = getattr(_TALLY, "d", None)
    if tally is not None:
        for attr in attrs:
            tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
        return
    with _COUNT_LOCK:
        for attr in attrs:
            setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def tally_launches():
    """Within the block, this thread's :func:`count_launch` calls land in
    the yielded dict ``{(wrapper, counter): n}`` and leave the counters as
    they were; other threads count as ever. A graph's capture runs its
    body here: the tally is the launches each replay stands for."""
    prev = getattr(_TALLY, "d", None)
    tally: Dict[tuple, int] = {}
    _TALLY.d = tally
    try:
        yield tally
    finally:
        _TALLY.d = prev


def add_launches(deltas, n: int = 1):
    """Add ``n`` times each ``(wrapper, counter, delta)`` of ``deltas``
    (a graph's replays, which call no wrapper)."""
    if not deltas:
        return
    with _COUNT_LOCK:
        for fn, attr, d in deltas:
            setattr(fn, attr, getattr(fn, attr) + n * d)


# Process-global, keyed by (device, stream). Launches on one stream run in
# order, so engines stepping on threads of their own may share a stream's
# buffer; the lock keeps two threads from (re)allocating it at once.
_COUNTERS: Dict[tuple, torch.Tensor] = {}
_COUNTERS_LOCK = threading.Lock()
# buffers a larger one replaced: a CUDA graph captured on the stream keeps
# launching its kernels on the old pointer, so the old buffer stays alive
_OUTGROWN: List[torch.Tensor] = []


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for the kernels that merge
    their split partials inside the launch (``last_to_arrive`` in
    ``csrc/common.cuh``), one buffer per device and stream: zeroed once
    when it is made (or grown), and left zeroed by every launch that uses
    it, so the host never clears or reads it. Launches on one stream run
    in order, so they share the buffer safely; so do the replays of the
    graphs captured on a stream, which run on one stream in turn. A step
    is warmed up on its capture stream before the capture, so the buffer
    is made outside the graph."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, stream_ptr(device))
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < n:
            if buf is not None:
                _OUTGROWN.append(buf)
            buf = torch.zeros(max(n, 4096), dtype=torch.int32,
                              device=device)
            _COUNTERS[key] = buf
        return buf
