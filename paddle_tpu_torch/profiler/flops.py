"""Matmul FLOPs of a torch callable (after
``paddle_tpu/profiler/flops.py``, which walks a jaxpr and sums its
``dot_general`` FLOPs with loop trip counts applied).

The port runs the callable once under
``torch.utils.flop_counter.FlopCounterMode`` and keeps the matmul family
(``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_scaled_mm``): 2 x M x N x K a
product, batches multiplied, as the reference counts a ``dot_general``.
Eager code runs every loop iteration and every branch it takes, so trip
counts come for free; a rematerialised forward inside a backward is
counted when the callable runs the backward. Convolutions and attention
kernels are not counted, as the reference counts neither.
"""
from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["dot_flops_of", "count_torch_dot_flops"]

_MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm")


def count_torch_dot_flops(fn, *args, **kwargs) -> Tuple[float, Dict]:
    """Run ``fn(*args, **kwargs)`` and count its matmul FLOPs. Returns
    ``(flops, report)``; ``report["by_op"]`` holds the FLOPs of each aten
    op counted and ``report["result"]`` what ``fn`` returned."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        result = fn(*args, **kwargs)
    by_op = {}
    for op, n in mode.get_flop_counts().get("Global", {}).items():
        name = getattr(op, "__name__", str(op)).split(".")[0]
        if name in _MATMUL_OPS:
            by_op[name] = by_op.get(name, 0) + int(n)
    return float(sum(by_op.values())), {"by_op": by_op, "result": result}


def dot_flops_of(fn, *args, **kwargs) -> float:
    """The matmul FLOPs of one call of ``fn(*args, **kwargs)``."""
    return count_torch_dot_flops(fn, *args, **kwargs)[0]
