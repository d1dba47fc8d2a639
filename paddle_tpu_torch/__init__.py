"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference. This package mirrors
its public names and parameter layouts (``Linear`` weights are
``[in, out]``), so a state dict crosses over with no transposes. Each TPU
kernel on the ported path has a hand-written CUDA kernel for ``sm_90a``
under ``csrc/`` plus a plain PyTorch version beside its wrapper: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel.

This package never imports JAX or ``paddle_tpu``.
"""
from .framework.device import resolve_device, resolve_dtype
from .framework.random import get_seed, seed
from . import profiler  # noqa: F401
from .hapi import Model
from .serialization import load, save

__all__ = ["resolve_device", "resolve_dtype", "seed", "get_seed", "Model",
           "save", "load", "DataParallel", "profiler"]


def __getattr__(name):
    if name == "DataParallel":  # paddle.DataParallel
        from .distributed.parallel import DataParallel

        globals()["DataParallel"] = DataParallel
        return DataParallel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
