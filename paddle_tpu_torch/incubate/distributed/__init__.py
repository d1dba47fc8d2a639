"""Distributed incubating layers (port of ``paddle_tpu.incubate.distributed``)."""
from . import models

__all__ = ["models"]
