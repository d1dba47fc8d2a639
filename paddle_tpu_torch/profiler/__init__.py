"""The profiler facade (after ``paddle_tpu/profiler/__init__.py``) on
``torch.profiler``.

``Profiler`` keeps the reference's step-keyed windows (``make_scheduler``:
closed, ready and record steps, repeated) and its step-time summary; while
a window records, a ``torch.profiler.profile`` traces the host and, on the
card, the device (CUPTI). ``export_chrome_tracing(dir)`` is the
``on_trace_ready`` handler that writes each window's trace there as a
Chrome trace. ``RecordEvent`` is a host span
(``torch.profiler.record_function``).

``mfu`` is the reference's runtime readout: model FLOPs (6 N a token, or
``flops_per_token``) times tokens a second a card, over the card's peak.
The default peak comes from the card's name: the H100's dense bf16
tensor-core rate, 989 TF/s. Another card, or none, needs
``peak_flops_per_chip``. ``flops`` counts the matmul FLOPs of a torch
callable (``dot_flops_of``).
"""
from __future__ import annotations

import os
import time
from enum import Enum
from typing import Callable, Optional

from . import flops  # noqa: F401
from .flops import count_torch_dot_flops, dot_flops_of  # noqa: F401

__all__ = [
    "Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "mfu", "dot_flops_of",
    "count_torch_dot_flops",
]

# dense bf16 tensor-core peak of a card, by a name fragment
PEAK_FLOPS = {"H100": 989e12}


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """The state of each step (``paddle.profiler.make_scheduler``)."""
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` handler: each recorded window's trace goes to
    ``dir_name/<worker>_<n>.json`` (Chrome trace format)."""

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"pid{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_{prof._windows}.json")
        prof._torch_prof.export_chrome_trace(path)
        prof._last_export = path

    handler._dir = dir_name
    return handler


class RecordEvent:
    """A host span (``torch.profiler.record_function``)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._span = None

    def begin(self):
        import torch

        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()

    def end(self):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False):
        if isinstance(scheduler, tuple):
            lo, hi = scheduler
            scheduler = make_scheduler(closed=lo, ready=0, record=hi - lo,
                                       repeat=1)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._targets = targets
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._torch_prof = None
        self._is_tracing = False
        self._windows = 0
        self._last_export = None
        self._step_times = []
        self._t_last = None

    # -------------------------------------------------------------- control
    def _activities(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        want_gpu = (self._targets is None
                    or ProfilerTarget.GPU in self._targets)
        if want_gpu and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _start_trace(self):
        import torch

        self._torch_prof = torch.profiler.profile(
            activities=self._activities(), record_shapes=self._record_shapes,
            profile_memory=self._profile_memory)
        self._torch_prof.__enter__()

    def _stop_trace(self):
        self._torch_prof.__exit__(None, None, None)
        self._windows += 1
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def start(self):
        self._t_last = time.perf_counter()
        self._transition()

    def stop(self):
        if self._t_last is not None:
            self._step_times.append(time.perf_counter() - self._t_last)
            self._t_last = None
        if self._is_tracing:
            self._is_tracing = False
            self._stop_trace()

    def step(self):
        now = time.perf_counter()
        if self._t_last is not None:
            self._step_times.append(now - self._t_last)
        self._t_last = now
        self._step += 1
        self._transition()

    def _transition(self):
        state = (self._scheduler(self._step) if self._scheduler
                 else ProfilerState.RECORD)
        self._state = state
        if self._timer_only:
            return
        should = state in (ProfilerState.RECORD,
                           ProfilerState.RECORD_AND_RETURN)
        if should and not self._is_tracing:
            self._start_trace()
            self._is_tracing = True
        elif not should and self._is_tracing:
            self._is_tracing = False
            self._stop_trace()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -------------------------------------------------------------- summary
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        if not self._step_times:
            return "no steps recorded"
        import numpy as np

        ts = np.asarray(self._step_times) * 1e3
        steps_per_sec = 1e3 * len(ts) / ts.sum() if ts.sum() > 0 else 0.0
        lines = [
            "---- step time summary ----",
            f"steps: {len(ts)}   mean: {ts.mean():.2f} ms   p50: "
            f"{np.percentile(ts, 50):.2f} ms   p90: "
            f"{np.percentile(ts, 90):.2f} ms   p99: "
            f"{np.percentile(ts, 99):.2f} ms   max: {ts.max():.2f} ms",
            f"steps/sec: {steps_per_sec:.2f}",
        ]
        if self._last_export:
            lines.append(f"trace exported to: {self._last_export}")
        return "\n".join(lines)


def _card_peak() -> float:
    import torch

    if not torch.cuda.is_available():
        raise ValueError("mfu: no card to read a peak from; pass "
                         "peak_flops_per_chip")
    name = torch.cuda.get_device_name(0)
    for frag, peak in PEAK_FLOPS.items():
        if frag in name:
            return peak
    raise ValueError(f"mfu: no peak known for {name!r}; pass "
                     f"peak_flops_per_chip")


def mfu(n_params: int, tokens_per_sec_per_chip: float,
        peak_flops_per_chip: Optional[float] = None,
        flops_per_token: Optional[float] = None) -> float:
    """Model FLOPs utilisation: ``tokens_per_sec_per_chip`` times
    ``flops_per_token`` (default 6 ``n_params``: forward and backward,
    recomputation not counted) over ``peak_flops_per_chip`` (default: the
    card's, see the module doc)."""
    if peak_flops_per_chip is None:
        peak_flops_per_chip = _card_peak()
    fpt = flops_per_token if flops_per_token is not None else 6.0 * n_params
    return tokens_per_sec_per_chip * fpt / peak_flops_per_chip
