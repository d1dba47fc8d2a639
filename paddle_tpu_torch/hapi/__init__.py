"""hapi — the high-level ``Model`` API of the port (after
``paddle_tpu.hapi``)."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger)
from .model import Model

__all__ = ["Model", "callbacks", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "LRScheduler", "EarlyStopping"]
