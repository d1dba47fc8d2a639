"""GroupSharded (ZeRO stages 1-3) of the port (after
``paddle_tpu/distributed/sharding/group_sharded.py``).

``group_sharded_parallel(model, optimizer, level)`` returns ``(model,
optimizer, scaler)`` with the reference's three levels: ``"os"`` (the
optimizer state sharded), ``"os_g"`` (and the gradients reduce-scattered)
and ``"p_g_os"`` (and the parameters held as slices between steps). What
each level does on the ranks is in ``sharding_optimizer.py``.

:func:`add_sharding_axis` is the reference's placement rule on a
``dist_spec`` (a tuple of axis names, or None, a dim): the ``sharding``
axis goes on the first dim that its size, times the axes already on that
dim, divides; the spec is unchanged when none does. The port's sharded
optimizer cuts each rank's tensor by the same rule (on the shape the rank
holds, where ``mp`` already split it, the same dim comes out).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import torch

from .sharding_optimizer import LEVELS, ShardedOptimizer

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "add_sharding_axis", "GroupShardedModel"]


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names or ()
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def add_sharding_axis(shape, base_spec, mesh, axis: str = "sharding"):
    """``base_spec`` with ``axis`` added on the first dim of ``shape``
    that is divisible by the product of its axes' sizes and ``axis``'s
    (``mesh``: a ``DeviceMesh`` or ``{axis: size}``), trailing Nones
    dropped; unchanged when no dim fits or ``axis`` is already used."""
    sizes = _axis_sizes(mesh)
    degree = sizes.get(axis, 1)
    entries = list(base_spec or ()) + [None] * (len(shape)
                                               - len(base_spec or ()))

    def trim(es):
        while es and es[-1] is None:
            es = es[:-1]
        return tuple(es)

    if degree <= 1 or any(axis in _axes(e) for e in entries):
        return trim(entries)
    for i, dim in enumerate(shape):
        existing = 1
        for a in _axes(entries[i]):
            existing *= sizes.get(a, 1)
        if dim % (existing * degree) == 0 and dim >= existing * degree:
            e = entries[i]
            entries[i] = axis if e is None else _axes(e) + (axis,)
            return trim(entries)
    return trim(entries)


class GroupShardedModel(torch.nn.Module):
    """The model of ``group_sharded_parallel``: at ``p_g_os`` each forward
    first all-gathers the parameters that the sharded optimizer holds as
    slices (``ShardedOptimizer.gather_params``); otherwise it calls the
    model. The ``Layer`` surface is the wrapped model's."""

    def __init__(self, layer, level: str, optimizer: ShardedOptimizer):
        super().__init__()
        self._layers = layer
        self._level = level
        self._opt = optimizer

    def forward(self, *args, **kwargs):
        if self._level == "p_g_os":
            self._opt.gather_params()
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__") or name == "_layers":
                raise
            return getattr(self._modules["_layers"], name)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        self._opt.gather_params()
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        self._opt.gather_params()
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``(model, optimizer, scaler)`` sharded at ``level`` over ``group``
    (None: fleet's ``sharding`` group, else the world); ``dp_group``
    (None: fleet's ``dp`` group when the sharding group is fleet's and the
    dp degree is above 1) also averages the gradients. ``offload`` is not
    ported (raises)."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    opt = ShardedOptimizer(optimizer, group=group, level=level,
                           offload=offload, dp_group=dp_group)
    return GroupShardedModel(model, level, opt), opt, scaler


def _host(t):
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def save_group_sharded_model(model, output: str, optimizer=None):
    """Write the whole model (``model.pdparams``) and, with ``optimizer``,
    its whole state (``model.pdopt``) as pickled numpy dicts under
    ``output``, as the reference does (bf16 as f32). Every rank calls it
    (the state is gathered); the group's first rank writes."""
    layer = model._layers if isinstance(model, GroupShardedModel) else model
    opt = optimizer
    if isinstance(model, GroupShardedModel):
        model._opt.gather_params()
    osd = None
    if opt is not None:
        osd = (opt.gathered_state_dict() if isinstance(opt,
                                                       ShardedOptimizer)
               else opt.state_dict())
    group = opt._group if isinstance(opt, ShardedOptimizer) else None
    if group is not None and group.rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    sd = {k: _host(v) for k, v in layer.state_dict().items()}
    with open(os.path.join(output, "model.pdparams"), "wb") as f:
        pickle.dump(sd, f)
    if osd is not None:
        host = {k: _host(v) if isinstance(v, torch.Tensor) else v
                for k, v in osd.items()}
        with open(os.path.join(output, "model.pdopt"), "wb") as f:
            pickle.dump(host, f)
