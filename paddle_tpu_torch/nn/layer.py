"""The layer base and containers, after ``paddle_tpu/nn/layer.py``.

``Layer`` is a ``torch.nn.Module`` with the reference's parameter surface:
``create_parameter`` (a ``ParamAttr``'s initializer, else the layer's
default, else XavierNormal for a weight and zeros for a bias),
``add_parameter``, ``add_sublayer``, ``sublayers`` and ``set_state_dict``.
Children and parameters keep the reference's names (``LayerList`` and
``ParameterList`` number theirs ``"0"``, ``"1"``, ...), so a JAX state
dict loads by name.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_dtype
from ..framework.param_attr import ParamAttr
from . import initializer as I

__all__ = ["Layer", "LayerList", "ParameterList", "Sequential",
           "make_parameter"]


def _dtype(dtype):
    return torch.float32 if dtype is None else resolve_dtype(dtype)


def make_parameter(shape, attr=None, dtype=torch.float32, is_bias=False,
                   default_initializer=None, device=None, generator=None):
    """A parameter of ``shape`` built as ``Layer.create_parameter`` builds
    one: drawn on ``device`` by ``attr``'s initializer, else
    ``default_initializer``, else XavierNormal (zeros for a bias), from
    ``generator`` (the next ``framework.random`` generator when None).
    ``attr.trainable=False`` turns its gradient off. A given attr stays on
    the parameter as ``param_attr`` (its ``name``; the port's optimizers
    read neither ``learning_rate``, ``regularizer`` nor ``need_clip``)."""
    attr = ParamAttr._to_attr(attr)
    init = getattr(attr, "initializer", None) or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    t = torch.empty(tuple(int(s) for s in shape), device=device,
                    dtype=_dtype(dtype))
    init(t, generator)
    p = nn.Parameter(t, requires_grad=getattr(attr, "trainable", True)
                     is not False)
    if attr:
        p.param_attr = attr
    return p


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = _dtype(dtype)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None,
                         generator=None):
        """:func:`make_parameter` in the layer's dtype unless ``dtype``
        names another. The caller registers it (by attribute or
        :meth:`add_parameter`)."""
        return make_parameter(shape, attr, self._dtype if dtype is None
                              else dtype, is_bias, default_initializer,
                              device, generator)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def sublayers(self, include_self=False):
        return [m for m in self.modules() if include_self or m is not self]

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or array-likes) into
        the parameter or buffer of that name. Returns ``(missing,
        unexpected)`` names, as the reference does."""
        own = self.state_dict()
        unexpected = []
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            src = value if isinstance(value, torch.Tensor) \
                else torch.from_numpy(np.array(value))
            own[name].copy_(src)
        return [n for n in own if n not in state_dict], unexpected


class LayerList(nn.ModuleList, Layer):
    """Sublayers held in order, named ``"0"``, ``"1"``, ..."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList, Layer):
    """Parameters held in order, named ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class Sequential(nn.Sequential):
    """Layers called in order. Children are named ``"0"``, ``"1"``, ...
    (as in torch and the reference), or by ``(name, layer)`` pairs; one
    list or tuple of layers may stand for the arguments."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        super().__init__(OrderedDict(
            tuple(item) if isinstance(item, (list, tuple)) else (str(i), item)
            for i, item in enumerate(layers)))
