"""The tensor-parallel wrapper (after
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``) and the
slicing rule of a ``dist_spec``.

A parameter's ``dist_spec`` names, per dim, the mesh axis that dim is
split over (``None``: whole), as the reference's ``PartitionSpec``s do.
The reference places the full parameter on the mesh by it; here each rank
keeps its slice: :func:`shard_slices` gives the index of rank ``r`` of
``n`` along each named axis (contiguous blocks, block ``r``), and
:func:`apply_dist_specs` slices every parameter of a model that is not
already its rank's shard (``is_sharded``). The serving runner and
``convert.shard_state_dict`` slice by the same rule.

:class:`TensorParallel` slices the model's ``mp``-annotated parameters,
broadcasts the replicated ones from the ``mp`` group's first rank (so
every rank starts from the same values) and, on request, all-reduces the
replicated parameters' gradients over the group
(``apply_collective_grads``), as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .meta_parallel_base import MetaParallelBase
from .mp_layers import mp_group_of

__all__ = ["TensorParallel", "apply_dist_specs", "param_shardings",
           "shard_slices", "shard_tensor", "sharded_state_dict"]


def shard_slices(shape: Sequence[int], spec,
                 coords: Dict[str, Tuple[int, int]]) -> Tuple[slice, ...]:
    """The index of one rank's shard of a ``shape`` tensor: ``spec`` names
    an axis (or None) per leading dim; ``coords`` maps an axis to this
    rank's ``(index, size)`` along it. An axis missing from ``coords`` (or
    of size 1) keeps the dim whole. A dim that its axis does not divide
    raises ``ValueError``."""
    idx = []
    for d, size in enumerate(shape):
        axis = spec[d] if spec is not None and d < len(spec) else None
        r, n = coords.get(axis, (0, 1)) if axis is not None else (0, 1)
        if n <= 1:
            idx.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"dim {d} of size {size} is not divisible by "
                             f"the {axis} degree {n}")
        w = size // n
        idx.append(slice(r * w, (r + 1) * w))
    return tuple(idx)


def shard_tensor(t, spec, coords):
    """This rank's shard of ``t`` (a tensor or an ndarray): a contiguous
    copy, so the full one can be freed; ``t`` itself when nothing is
    split."""
    idx = shard_slices(t.shape, spec, coords)
    if all(s == slice(None) for s in idx):
        return t
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t[idx])
    return t[idx].contiguous()


def _distributed(p) -> bool:
    """Whether ``p`` is split over the ``mp`` group (``is_distributed`` set
    to True; a plain tensor's ``is_distributed`` is torch's method)."""
    return getattr(p, "is_distributed", False) is True


def _coords(group):
    return {"mp": (group.rank, group.nranks)} if group is not None else {}


def param_shardings(model, group=None) -> Dict[str, Optional[tuple]]:
    """``{name: index}`` of this rank's slice of each parameter by its
    ``dist_spec`` over the ``mp`` group (None: kept whole, or already the
    rank's shard)."""
    coords = _coords(mp_group_of(group))
    out = {}
    for name, p in model.named_parameters():
        spec = getattr(p, "dist_spec", None)
        if spec is None or getattr(p, "is_sharded", False):
            out[name] = None
            continue
        idx = shard_slices(p.shape, spec, coords)
        out[name] = None if all(s == slice(None) for s in idx) else idx
    return out


@torch.no_grad()
def apply_dist_specs(model, group=None):
    """Slice, in place, every parameter of ``model`` that its
    ``dist_spec`` splits over the ``mp`` group and that is not yet this
    rank's shard; returns the model."""
    for name, idx in param_shardings(model, group).items():
        p = model.get_parameter(name)
        if idx is not None:
            p.data = p.data[idx].contiguous()
            p.is_sharded = True
    return model


def sharded_state_dict(model, group=None) -> Dict[str, object]:
    """``{name: parameter}`` of ``model`` for ``checkpoint.save_state_dict
    (group=)``: a parameter that is this rank's shard (``is_sharded``) as
    a ``Shard`` at its block's offset in the full tensor its
    ``dist_spec`` splits over the ``mp`` group; the others whole."""
    from ...checkpoint import Shard

    g = mp_group_of(group)
    n, r = (1, 0) if g is None else (g.nranks, g.rank)
    out = {}
    for name, p in model.named_parameters():
        spec = getattr(p, "dist_spec", None)
        if not getattr(p, "is_sharded", False) or spec is None or n <= 1:
            out[name] = p
            continue
        offset, full = [], []
        for d, size in enumerate(p.shape):
            split = d < len(spec) and spec[d] == "mp"
            offset.append(r * size if split else 0)
            full.append(size * n if split else size)
        out[name] = Shard(p, tuple(offset), tuple(full))
    return out


class TensorParallel(MetaParallelBase):
    """Wraps a model whose tensor-parallel layers are the
    Column/Row/VocabParallel ones (or carry ``dist_spec``s): slices and
    broadcasts at wrap (see the module doc)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        self._group = (hcg.get_model_parallel_group() if hcg is not None
                       else mp_group_of(None))
        self._prepare_for_model()

    @torch.no_grad()
    def _prepare_for_model(self):
        from ...collective import broadcast

        apply_dist_specs(self._layers, self._group)
        g = self._group
        if g is None or g.nranks <= 1:
            return
        for p in self._layers.parameters():
            if not _distributed(p):
                broadcast(p.data, g.ranks[0], group=g)

    def apply_collective_grads(self):
        """All-reduce (sum) the gradients of the replicated parameters
        over the ``mp`` group."""
        from ...collective import ReduceOp, all_reduce

        g = self._group
        if g is None or g.nranks <= 1:
            return
        for p in self._layers.parameters():
            if not _distributed(p) and p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.SUM, group=g)
