"""The KV handoff payload codec, after ``paddle_tpu/serving/replica.py``
(its ``encode_kv_payload`` / ``decode_kv_payload``).

A handoff payload (``CacheCoordinator.export_handoff``) carries, per page,
one row per pool buffer. To cross ``POST /v1/kv`` as JSON each row becomes
a ``{dtype, shape, b64}`` triple; digests, checksums and tokens are JSON
already. The reference resolves a bf16 row's dtype through ``ml_dtypes``,
which the port does not use: here a bf16 row travels as its raw 2-byte
words under the dtype name ``"bfloat16"`` (the reference's own name for
it, so either side reads the other's JSON) and decodes to a torch bf16
view of them. Decoded rows are torch tensors on the host.

``Replica``, ``InProcReplica`` and the subprocess transport of the
reference's module come with the router and the cluster layer (ROADMAP
A4).
"""
from __future__ import annotations

import base64
from typing import Dict

import numpy as np
import torch

__all__ = ["encode_kv_payload", "decode_kv_payload"]


def _encode_row(a) -> Dict:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous().cpu()
        name = str(a.dtype).replace("torch.", "")
        raw = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
        data, shape = raw.numpy().tobytes(), list(a.shape)
    else:
        a = np.ascontiguousarray(a)
        name, data, shape = str(a.dtype), a.tobytes(), list(a.shape)
    return {"dtype": name, "shape": shape,
            "b64": base64.b64encode(data).decode("ascii")}


def _decode_row(d: Dict) -> torch.Tensor:
    # a writable buffer, which torch.from_numpy wants
    raw = bytearray(base64.b64decode(d["b64"]))
    if d["dtype"] == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(d["shape"])
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]))


def encode_kv_payload(payload: Dict) -> Dict:
    """JSON-encode a KV handoff payload: each page row (a host tensor or a
    numpy array) becomes ``{dtype, shape, b64}``."""
    out = dict(payload)
    out["pages"] = [[_encode_row(a) for a in rows]
                    for rows in payload["pages"]]
    return out


def decode_kv_payload(obj: Dict) -> Dict:
    """Inverse of :func:`encode_kv_payload`: rows come back as host
    tensors (bf16 from its raw words)."""
    out = dict(obj)
    out["pages"] = [[_decode_row(d) for d in rows] for rows in obj["pages"]]
    return out
