"""Vision models of the port (after ``paddle_tpu.vision``)."""
from . import models

__all__ = ["models"]
