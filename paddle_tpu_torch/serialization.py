"""``save`` / ``load``, after ``paddle_tpu/serialization.py``: a pickle in
which each tensor is a ``_TensorPickle`` holding a numpy array, written
atomically (a sibling temporary file, fsync, ``os.replace``).

``load`` reads the port's files and the reference's: an unpickler maps
``paddle_tpu.serialization._TensorPickle`` to this module's class, so no
``paddle_tpu`` import happens. numpy has no bfloat16 without
``ml_dtypes``, so the port stores a bf16 tensor as its uint16 bits with
``dtype = "bfloat16"`` on the holder (``_host_array`` / ``_from_host``,
which the checkpoint writer shares).
"""
from __future__ import annotations

import os
import pickle
import uuid
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "load"]

BF16 = "bfloat16"


class _TensorPickle:
    """Placeholder written into the pickle stream for each tensor."""

    def __init__(self, array: np.ndarray, dtype: Optional[str] = None):
        self.array = array
        self.dtype = dtype


def _host_array(t: torch.Tensor):
    """``(host numpy copy, dtype name)``; bf16 comes back as its uint16
    bits. Always a copy, so later writes to ``t`` do not reach it."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: Optional[str] = None) -> torch.Tensor:
    """A CPU tensor of ``a``; ``dtype="bfloat16"`` reads ``a``'s 16-bit
    words (uint16, or the reference's ``V2`` ``.npy`` words) as bf16."""
    if dtype == BF16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPickle" and module in ("paddle_tpu.serialization",
                                                  __name__):
            return _TensorPickle
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPickle(*_host_array(obj))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        packed = [_pack(v) for v in obj]
        try:
            return t(packed)
        except TypeError:  # namedtuple
            return t(*packed)
    return obj


def _unpack(obj, return_tensor=True):
    if isinstance(obj, _TensorPickle):
        dtype = getattr(obj, "dtype", None)
        if return_tensor or dtype == BF16:
            return _from_host(obj.array, dtype)
        return obj.array
    if isinstance(obj, dict):
        return {k: _unpack(v, return_tensor) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        unpacked = [_unpack(v, return_tensor) for v in obj]
        try:
            return t(unpacked)
        except TypeError:
            return t(*unpacked)
    return obj


def save(obj: Any, path: str, protocol: int = 4):
    """Pickle ``obj`` (tensors as host copies) to ``path``; a crash
    mid-write leaves the old file or the new one, never a torn one."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_pack(obj), f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, return_numpy: bool = False):
    """What ``save`` (of either package) wrote: tensors as CPU tensors, or
    numpy arrays with ``return_numpy`` (bf16 stays a tensor)."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_tensor=not return_numpy)
