"""AMP: autocast lists, ``decorate`` and ``GradScaler``, after
``paddle_tpu/amp/__init__.py``.

O1 casts the inputs of white-list ops (matmul-class) to the low-precision
dtype, O2 casts every op's inputs outside the black list. The functional
ops call :func:`amp_cast` where the reference does (``linear`` and
``attention``). bf16 needs no loss scaling, so ``GradScaler(enable=False)``
keeps the API while multiplying by 1; enabled, it does dynamic loss
scaling (for float16).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework.device import resolve_dtype

__all__ = ["auto_cast", "amp_guard", "amp_cast", "decorate", "GradScaler",
           "is_auto_cast_enabled", "get_amp_dtype", "get_amp_level",
           "WHITE_LIST", "BLACK_LIST"]

_tls = threading.local()

# ops whose inputs are cast down under O1 (matmul-class)
WHITE_LIST = {"matmul", "linear", "conv2d", "conv1d", "conv3d", "einsum",
              "attention"}
# ops kept in f32 even under O2 (numerics-sensitive)
BLACK_LIST = {"softmax", "log_softmax", "layer_norm", "batch_norm",
              "group_norm", "cross_entropy", "mean", "sum", "exp", "log",
              "rms_norm", "logsumexp"}
_LOW = (torch.float16, torch.bfloat16)


def _state():
    if not hasattr(_tls, "amp"):
        _tls.amp = {"enabled": False, "dtype": torch.bfloat16, "level": "O1",
                    "custom_white": set(), "custom_black": set()}
    return _tls.amp


def is_auto_cast_enabled() -> bool:
    return _state()["enabled"]


def get_amp_dtype() -> torch.dtype:
    return _state()["dtype"]


def get_amp_level() -> str:
    return _state()["level"]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    st = _state()
    prev = dict(st)
    st["enabled"] = enable
    st["dtype"] = resolve_dtype(dtype)
    st["level"] = level
    st["custom_white"] = set(custom_white_list or ())
    st["custom_black"] = set(custom_black_list or ())
    try:
        yield
    finally:
        st.update(prev)


amp_guard = auto_cast


def amp_cast(op_name, *tensors):
    """Cast an op's inputs per the active AMP policy (a tuple back)."""
    st = _state()
    if not st["enabled"]:
        return tensors
    black = (BLACK_LIST | st["custom_black"]) - st["custom_white"]
    if op_name in black:
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _LOW else t for t in tensors)
    if st["level"] == "O2" or op_name in (WHITE_LIST | st["custom_white"]):
        dt = st["dtype"]
        return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                     and t.is_floating_point() and t.dtype != dt else t
                     for t in tensors)
    return tensors


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """O2 casts the models' floating parameters and buffers to the AMP
    dtype. The optimizers keep f32 master weights of low-precision
    parameters themselves (``multi_precision``), so nothing else changes."""
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        for m in ms:
            m.to(dtype=resolve_dtype(dtype))
    out = models if single else ms
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Dynamic loss scaling (reference: ``paddle_tpu.amp.GradScaler``).
    ``enable=False`` (what bf16 needs) multiplies by 1 and never skips."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts: set = set()

    def scale(self, loss):
        return loss * self._scale if self._enable else loss

    def unscale_(self, optimizer):
        """Divide the gradients by the scale and note whether any is not
        finite (one host sync: the step is skipped on overflow)."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameter_list():
            if p.grad is not None:
                p.grad.mul_(inv)
                b = (~torch.isfinite(p.grad)).any()
                bad = b if bad is None else bad | b
        self._found_inf = bool(bad) if bad is not None else False
        self._unscaled_opts.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        # idempotent per step: unscale, clip, then step divides once
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        self._unscaled_opts.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, st):
        self._scale = st["scale"]
        self._good_steps = st["good_steps"]
        self._bad_steps = st["bad_steps"]
