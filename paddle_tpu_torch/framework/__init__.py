from .device import resolve_device, resolve_dtype
from .flags import get_flags, set_flags

__all__ = ["resolve_device", "resolve_dtype", "get_flags", "set_flags"]
