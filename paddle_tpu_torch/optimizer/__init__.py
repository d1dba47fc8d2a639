"""Optimizers and LR schedulers of the port (after
``paddle_tpu.optimizer``)."""
from . import lr
from .optimizer import (SGD, Adagrad, Adam, AdamW, Lamb, Momentum,
                        Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Lamb"]
