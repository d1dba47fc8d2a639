"""``communication.stream`` (after
``paddle_tpu/distributed/communication/stream.py``): the collectives with
the reference's ``sync_op`` / ``use_calc_stream`` arguments, each
returning a waitable :class:`Task`.

The collectives run on the calling stream and have finished (on the host's
side) when the wrapper returns, so the task is complete: ``wait()`` and
``is_completed()`` hold at once, as in the reference.
"""
from __future__ import annotations

from .. import collective as _c

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "broadcast", "reduce", "scatter", "send", "recv", "Task"]


class Task:
    """A finished collective's handle (the reference's
    ``ProcessGroup::Task``)."""

    def wait(self):
        return True

    def is_completed(self):
        return True


def _wrap(fn):
    def op(*args, sync_op=True, use_calc_stream=False, **kwargs):
        fn(*args, **kwargs)
        return Task()

    op.__name__ = fn.__name__
    op.__doc__ = f"stream.{fn.__name__} (see collective.{fn.__name__})"
    return op


all_reduce = _wrap(_c.all_reduce)
all_gather = _wrap(_c.all_gather)
reduce_scatter = _wrap(_c.reduce_scatter)
all_to_all = _wrap(_c.all_to_all)
broadcast = _wrap(_c.broadcast)
reduce = _wrap(_c.reduce)
scatter = _wrap(_c.scatter)
send = _wrap(_c.send)
recv = _wrap(_c.recv)
