"""The rank-0 logger (after
``paddle_tpu/distributed/fleet/utils/log_util.py``): records pass only on
rank 0 of the world."""
from __future__ import annotations

import logging
import sys


class _Rank0Filter(logging.Filter):
    def filter(self, record):
        from ...parallel import get_rank

        return get_rank() == 0


logger = logging.getLogger("paddle_tpu_torch.fleet")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [rank-0] %(message)s"))
    _h.addFilter(_Rank0Filter())
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_log_level(level):
    logger.setLevel(level)


def layer_to_str(base, *args, **kwargs):
    name = base + "("
    name += ", ".join(str(a) for a in args)
    if kwargs:
        name += ", " + ", ".join(f"{k}={v}" for k, v in kwargs.items())
    return name + ")"
