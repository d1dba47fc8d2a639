"""The compiled path, after ``paddle_tpu/jit/__init__.py``: ``to_static``,
``functional_call`` and ``save`` / ``load``.

* ``functional_call(layer, state, *args)`` runs ``layer`` as a function of
  an explicit ``{name: tensor}`` state (``torch.func.functional_call``):
  autograd differentiates with respect to the state's tensors, so a
  training step is ``functional_call`` + ``torch.autograd.grad`` + the
  optimizer's ``apply_gradients_tree``.
* ``to_static(fn_or_layer)`` is ``torch.compile(fullgraph=full_graph)``.
  The reference's default is ``full_graph=True``, so a graph break raises
  instead of quietly running eagerly. The flash kernels are registered
  operators (``ops/cuda/flash_attention.py``), so a compiled program calls
  them as opaque nodes: kernel #2 launches (and counts) inside it.
* ``save(layer, prefix, input_spec)`` mirrors the reference's split: the
  program, a function of ``(state, *inputs)`` with the state as an
  *input* rather than baked constants, is exported with
  ``torch.export`` into ``<prefix>.pt2`` (an ``InputSpec`` dim of None or
  -1 becomes a ``torch.export.Dim``); the state goes to
  ``<prefix>.pdiparams``, the reference's pickle of ``{name: numpy
  array}`` under the same keys (bf16 as its uint16 bits, numpy having no
  bfloat16; the ``.pt2`` records each entry's dtype). ``load`` imports
  the operators' registrations, reads both files and returns a
  ``TranslatedLayer`` on the card (or the device it is given).

This module imports nothing of JAX or ``paddle_tpu``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pickle
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..framework.device import resolve_device, resolve_dtype
from ..serialization import _from_host, _host_array

__all__ = ["InputSpec", "functional_call", "state_arrays", "param_arrays",
           "buffer_arrays", "swapped_tensors", "swapped_params",
           "StaticFunction", "to_static", "save", "load",
           "TranslatedLayer"]

_INT_DTYPES = {"int32": torch.int32, "int64": torch.int64,
               "int16": torch.int16, "uint8": torch.uint8,
               "bool": torch.bool}
_META = "paddle_tpu_torch.json"  # the .pt2's record of dtypes and inputs


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    key = str(name).lower().replace("torch.", "")
    return _INT_DTYPES.get(key) or resolve_dtype(key)


class InputSpec:
    """Shape and dtype of one traced input (the reference's
    ``paddle.static.InputSpec``); a dim of None or -1 is dynamic."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def has_dynamic_dims(self):
        return any(s is None or s == -1 for s in self.shape)

    def example(self, device=None) -> torch.Tensor:
        """Zeros of this spec, a dynamic dim at size 2 (the least size
        ``torch.export`` does not specialise)."""
        shape = [2 if s is None or s == -1 else int(s) for s in self.shape]
        return torch.zeros(shape, dtype=_dtype(self.dtype), device=device)

    def dynamic_shapes(self, index: int):
        """``{dim: torch.export.Dim}`` of the dynamic dims, or None."""
        dims = {d: torch.export.Dim(f"x{index}_d{d}")
                for d, s in enumerate(self.shape) if s is None or s == -1}
        return dims or None

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# ------------------------------------------------------------------ state
def param_arrays(layer) -> Dict[str, torch.Tensor]:
    """Trainable parameters as a flat ``{name: tensor}`` dict (detached
    views of the parameters' storage)."""
    return {name: p.detach() for name, p in layer.named_parameters()
            if p.requires_grad}


def buffer_arrays(layer) -> Dict[str, torch.Tensor]:
    return {name: b.detach() for name, b in layer.named_buffers()
            if b is not None}


def state_arrays(layer) -> Dict[str, torch.Tensor]:
    out = param_arrays(layer)
    out.update(buffer_arrays(layer))
    return out


# Swapping state into a module mutates the module; two threads swapping
# into one layer at once would leave it holding the other's tensors. One
# process-wide reentrant lock serialises the swap -> call -> restore
# window, as in the reference.
_SWAP_LOCK = threading.RLock()


@contextlib.contextmanager
def swapped_tensors(tensors, arrays):
    """Put ``arrays``' values into an explicit list of tensors for the
    duration of the block (``tensor.data``, so no autograd through the
    swap), then put the old values back."""
    with _SWAP_LOCK:
        saved = [t.data for t in tensors]
        try:
            for t, a in zip(tensors, arrays):
                t.data = a
            yield
        finally:
            for t, d in zip(tensors, saved):
                t.data = d


@contextlib.contextmanager
def swapped_params(layer, arrays):
    """Bind ``arrays`` (ordered like ``layer.named_parameters()``) as the
    layer's parameters for the duration of the block, differentiably:
    the multi-call sibling of :func:`functional_call`."""
    from torch.nn.utils.stateless import _reparametrize_module

    names = [name for name, _ in layer.named_parameters()]
    with _SWAP_LOCK, _reparametrize_module(layer, dict(zip(names, arrays))):
        yield


def functional_call(layer, state: Dict[str, Any], *args,
                    return_buffers: bool = False, **kwargs):
    """``layer(*args, **kwargs)`` with the tensors of ``state`` (keyed as
    ``named_parameters`` / ``named_buffers``) in place of the layer's own;
    names missing from ``state`` keep the layer's. An unknown name raises
    ``KeyError``. With ``return_buffers`` also returns the state's buffers
    after the call (a training BatchNorm updates them in place)."""
    known = dict(layer.named_parameters())
    known.update(dict(layer.named_buffers()))
    for name in state:
        if name not in known:
            raise KeyError(f"functional_call: state key {name!r} not found "
                           f"in layer")
    with _SWAP_LOCK:
        out = torch.func.functional_call(layer, dict(state), args, kwargs,
                                         strict=False)
    if return_buffers:
        bufs = {name for name, _ in layer.named_buffers()}
        return out, {name: state[name] for name in state if name in bufs}
    return out


# ------------------------------------------------------------------ to_static
def _arg_signature(xs, dyn_kw, static_kw) -> str:
    """Shape/dtype signature of a call, e.g. ``float32[8,128]|int32[8]``:
    what a new compile is keyed on, readable in a log."""
    parts = []
    for leaf in torch.utils._pytree.tree_leaves((list(xs), dyn_kw)):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            dt = str(leaf.dtype).replace("torch.", "")
            parts.append(f"{dt}[{','.join(str(s) for s in leaf.shape)}]")
        else:
            parts.append(type(leaf).__name__)
    if static_kw:
        parts.append(f"static{static_kw!r}")
    return "|".join(parts)


def _is_layer(obj) -> bool:
    return isinstance(obj, torch.nn.Module)


class StaticFunction:
    """What ``to_static`` returns: ``torch.compile(fn_or_layer,
    fullgraph=full_graph)``, with the signatures it has been called with
    (``signatures``; a new one is a compile, as in the reference's
    program cache)."""

    def __init__(self, fn_or_layer, input_spec=None, build_strategy=None,
                 full_graph=True):
        self._target = fn_or_layer
        self._input_spec = input_spec
        self._is_layer = _is_layer(fn_or_layer)
        self._compiled = torch.compile(fn_or_layer, fullgraph=full_graph)
        self._seen_sigs = []

    @property
    def _layer(self):
        return self._target if self._is_layer else None

    @property
    def signatures(self):
        return list(self._seen_sigs)

    def __call__(self, *args, **kwargs):
        dyn_kw = {k: v for k, v in kwargs.items()
                  if isinstance(v, torch.Tensor)}
        static_kw = tuple(sorted((k, v) for k, v in kwargs.items()
                                 if k not in dyn_kw))
        sig = _arg_signature(args, dyn_kw, static_kw)
        if sig not in self._seen_sigs:
            self._seen_sigs.append(sig)
        return self._compiled(*args, **kwargs)

    def concrete_program(self):
        return self._compiled


def to_static(function=None, input_spec=None, build_strategy=None,
              full_graph=True, **kwargs):
    """``@paddle.jit.to_static``: a compiled ``StaticFunction`` over a
    function or a layer (``torch.compile`` under the hood)."""
    if function is None:
        return functools.partial(to_static, input_spec=input_spec,
                                 build_strategy=build_strategy,
                                 full_graph=full_graph, **kwargs)
    wrapper = StaticFunction(function, input_spec=input_spec,
                             full_graph=full_graph)
    if not wrapper._is_layer:
        functools.update_wrapper(wrapper, function, updated=[])
    return wrapper


# ------------------------------------------------------------------ save/load
class _Program(torch.nn.Module):
    """``(state, *inputs) -> layer(*inputs)`` with ``state`` bound by
    :func:`functional_call`. The layer is not registered as a submodule,
    so its tensors reach the exported program only as the ``state``
    input."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, state, *xs):
        return torch.func.functional_call(self._layer, state, xs)


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **config):
    """``paddle.jit.save``: ``<path>.pt2`` (the exported program, state as
    an input) and ``<path>.pdiparams`` (the state). ``input_spec`` holds
    an ``InputSpec`` (or an example tensor) for each input."""
    if isinstance(layer, StaticFunction):
        layer = layer._target
    if input_spec is None:
        raise ValueError("paddle_tpu_torch.jit.save requires input_spec")
    state = state_arrays(layer)
    device = next(iter(state.values())).device if state else None
    specs = [s if isinstance(s, InputSpec)
             else InputSpec(tuple(s.shape), s.dtype) for s in input_spec]
    examples = tuple(s.example(device) for s in specs)
    dynamic = ({name: None for name in state},
               tuple(s.dynamic_shapes(i) for i, s in enumerate(specs)))
    with torch.no_grad():
        program = torch.export.export(_Program(layer), (state,) + examples,
                                      dynamic_shapes=dynamic, strict=False)
    host = {name: _host_array(t) for name, t in state.items()}
    meta = {"state": {name: dt for name, (_, dt) in host.items()},
            "inputs": len(specs),
            "device": "cpu" if device is None else device.type}
    torch.export.save(program, path + ".pt2",
                      extra_files={_META: json.dumps(meta)})
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({name: a for name, (a, _) in host.items()}, f)


class TranslatedLayer:
    """A loaded program (the reference's ``TranslatedLayer``): call it on
    tensors or numpy arrays; the state is bound on every call."""

    def __init__(self, program, state, num_inputs, device):
        self._program = program
        self._module = program.module()
        self._state = state
        self.num_inputs = num_inputs
        self.device = device

    def __call__(self, *args):
        xs = [torch.as_tensor(a).to(self.device) for a in args]
        with torch.no_grad():
            return self._module(self._state, *xs)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        return self


def load(path: str, device=None) -> TranslatedLayer:
    """Read ``<path>.pt2`` and ``<path>.pdiparams`` into a
    ``TranslatedLayer`` on ``device`` (the card unless the caller names
    the CPU); a program exported on another device is moved there."""
    from ..ops.cuda import flash_attention  # noqa: F401 (registers ops)

    extra = {_META: ""}
    program = torch.export.load(path + ".pt2", extra_files=extra)
    meta = json.loads(extra[_META])
    dev = resolve_device(device)
    if meta["device"] != dev.type:
        program = torch.export.passes.move_to_device_pass(program, dev)
    with open(path + ".pdiparams", "rb") as f:
        arrays = pickle.load(f)
    state = {name: _from_host(arrays[name], dt).to(dev)
             for name, dt in meta["state"].items()}
    return TranslatedLayer(program, state, meta["inputs"], dev)
