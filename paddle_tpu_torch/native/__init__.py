"""Native (C++) host components of the port, loaded with ctypes (after
``paddle_tpu/native/__init__.py``).

Each is built with g++ at first use by ``kernels/build.py``
(:func:`~paddle_tpu_torch.kernels.build.build_host`) into the git-ignored
``build/paddle_tpu_torch/``. A component that does not build is None, and
its user takes a pure-Python fallback (the TCP store's Python server and
client speak the same wire protocol).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

__all__ = ["load", "tcp_store_lib"]

_HERE = Path(__file__).resolve().parent
_lock = threading.Lock()
_libs: dict = {}


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load ``native/<name>.cc``; None on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        from ..kernels.build import build_host

        so = build_host(_HERE / f"{name}.cc")
        try:
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except OSError:
            lib = None
        _libs[name] = lib
        return lib


def tcp_store_lib() -> Optional[ctypes.CDLL]:
    """The native TCP store's library with its C signatures, or None."""
    lib = load("tcp_store")
    if lib is None:
        return None
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ts_server_start.restype = p
    lib.ts_server_start.argtypes = [i]
    lib.ts_server_stop.argtypes = [p]
    lib.ts_client_connect.restype = p
    lib.ts_client_connect.argtypes = [ctypes.c_char_p, i, i]
    lib.ts_client_close.argtypes = [p]
    lib.ts_set.restype = i64
    lib.ts_set.argtypes = [p, ctypes.c_char_p, u8p, ctypes.c_uint32]
    lib.ts_get.restype = i64
    lib.ts_get.argtypes = [p, ctypes.c_char_p, i64, u8p, ctypes.c_uint32,
                           ctypes.POINTER(ctypes.c_uint32)]
    lib.ts_add.restype = i64
    lib.ts_add.argtypes = [p, ctypes.c_char_p, i64]
    lib.ts_check.restype = i64
    lib.ts_check.argtypes = [p, ctypes.c_char_p]
    lib.ts_delete.restype = i64
    lib.ts_delete.argtypes = [p, ctypes.c_char_p]
    return lib
