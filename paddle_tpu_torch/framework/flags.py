"""FLAGS registry, after ``paddle_tpu/framework/flags.py``: a dict of
typed flags with an environment override (``FLAGS_xxx``) read when the
flag is defined, and the ``set_flags`` / ``get_flags`` API.

Only the flags the port reads are defined:

* ``FLAGS_use_flash_attention`` (True): ``F.flash_attention`` runs the
  flash kernels; False sends it to ``naive_attention``.
* ``FLAGS_use_packed_attention`` (None): the GPT train path's packed-QKV
  causal kernel. None means "packed when the activations are on CUDA",
  the port's reading of the reference's "TPU only"; True forces it (the
  plain versions on the CPU), False turns it off.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags"]

_REGISTRY: Dict[str, Any] = {}


def _name(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _parse(env: str, default):
    if default is None or isinstance(default, bool):
        low = env.lower()
        if default is None and low in ("", "none", "auto"):
            return None
        return low in ("1", "true", "yes")
    return type(default)(env)


def define_flag(name: str, default, help_str: str = ""):
    name = _name(name)
    env = os.environ.get(name)
    value = default if env is None else _parse(env, default)
    _REGISTRY[name] = value
    return value


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        _REGISTRY[_name(k)] = v


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {_name(k): _REGISTRY.get(_name(k)) for k in names}


define_flag("FLAGS_use_flash_attention", True,
            "route attention through the flash kernels")
define_flag("FLAGS_use_packed_attention", None,
            "packed-QKV causal kernel on the GPT train path: None = auto "
            "(CUDA activations), True = force, False = off")
define_flag("FLAGS_fault_inject",
            os.environ.get("PADDLE_TPU_FAULT_INJECT", ""),
            "deterministic fault-injection plan for the serving engine "
            "(paddle_tpu_torch.testing.faultinject). Grammar: "
            "'point[:key=val,...][;point2:...]', e.g. "
            "'nan-logits:rid=2,times=1;slow-step:every=4,delay_ms=30'. "
            "Empty (the default) disables injection; also settable via "
            "env PADDLE_TPU_FAULT_INJECT. Engine(fault_plan=...) "
            "overrides per instance")
