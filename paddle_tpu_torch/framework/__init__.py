from .device import resolve_device, resolve_dtype
from .flags import get_flags, set_flags
from .param_attr import ParamAttr

__all__ = ["resolve_device", "resolve_dtype", "get_flags", "set_flags",
           "ParamAttr"]
