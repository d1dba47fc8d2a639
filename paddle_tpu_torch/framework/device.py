"""Device and dtype resolution for the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU by name. There is no silent fallback: asking for CUDA on a
machine without a card raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_dtype"]

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
    "int8": torch.int8,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises when there
    is no card); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` or one of its names (``"bfloat16"``, ``"bf16"``,
    ``"float32"`` ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).lower().replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]

