"""hapi callbacks, after ``paddle_tpu/hapi/callbacks.py``: Callback,
ProgBarLogger, ModelCheckpoint, LRScheduler, EarlyStopping. (``VisualDL``
is not ported: it writes through ``utils/tbevents.py``, which the port
lacks.)"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "CallbackList"]


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params: Dict):
        self.params = params

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def fanout(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return fanout


class ProgBarLogger(Callback):
    """Per-epoch progress/metric printer (reference: hapi ProgBarLogger)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs") if hasattr(self, "params") else "?"
            print(f"Epoch {epoch + 1}/{total}", file=sys.stderr)

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and self.steps % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                              f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"step {self.steps}: {items}", file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                              f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1} done ({dt:.1f}s): {items}",
                  file=sys.stderr)


class ModelCheckpoint(Callback):
    """Save every N epochs (reference: hapi ModelCheckpoint — saves
    ``{save_dir}/{epoch}`` and ``final``)."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference: hapi LRScheduler —
    by_step or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None) if opt else None
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference: hapi
    EarlyStopping)."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, min_delta: float = 0.0,
                 baseline=None, save_best_model: bool = True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.stopped_epoch = 0
        self.best = None

    def _better(self, cur) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True
