from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
