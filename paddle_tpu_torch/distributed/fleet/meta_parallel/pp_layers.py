"""Pipeline-parallel model authoring (after
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``):
``LayerDesc``, ``SharedLayerDesc`` and ``PipelineLayer``.

The port runs one process a rank, so a ``PipelineLayer`` materialises only
the layers of this rank's stage, as upstream Paddle does (the reference,
one SPMD program, builds the whole model everywhere). The layout is the
reference's:

* ``pre`` — the leading layers before the longest run of equal layers
  (the embedding): virtual stage 0;
* ``body`` — that run (the transformer blocks), cut into ``num_stages x
  num_virtual_pipeline_stages`` chunks of equal length; chunk ``d`` is
  virtual stage ``d``, held by stage ``d % num_stages`` as its chunk
  ``d // num_stages``;
* ``post`` — the trailing layers (final norm, head): the last virtual
  stage.

Equal layers are found without building them: two ``LayerDesc`` entries
are equal when they name the same class with the same arguments (a built
layer compares by class and its parameters' and buffers' names, shapes
and dtypes, as the reference compares every layer). ``seg_method``
``"layer:Name"`` takes the body from the first to the last layer of class
``Name`` instead, and every layer in that span must be equal. A body that
the chunk count does not divide raises ``ValueError``, as the reference's.

Every local layer keeps its global name ``run_function.{i}.…``, so a state
dict of the reference's whole model maps onto each rank's part with no
renaming (``convert.pipeline_stage_from_numpy``), and ``parameters()``
holds this rank's parameters only.

A ``SharedLayerDesc`` ties a weight across its uses. Its first use builds
the layer; a later use on the same stage borrows it (no parameters of its
own); a later use on another stage builds a copy of the first use's layer
there, under the first use's name, which ``PipelineParallel`` keeps equal
to the first (a broadcast at wrap, the gradients summed over the stages
that hold it). ``PipelineParallel`` refuses a shared layer inside the body,
as the reference does.

Without a running pipeline (no ``fleet`` world with ``pp_degree`` equal to
``num_stages``) one process holds every stage, and ``forward`` is the whole
sequential model: the twin the schedules are held against.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from ....nn.layer import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer to build later (upstream: ``pp_layers.LayerDesc``)."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, torch.nn.Module)):
            raise TypeError(f"LayerDesc expects an nn.Layer subclass, got "
                            f"{layer_cls}")
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> torch.nn.Module:
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose ``shared_weight_attr`` is tied across every desc of
    the same ``key`` (tied input and output embeddings); a later use runs
    ``forward_func(master_layer, *args)`` when one is given."""

    def __init__(self, key, layer_cls, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedLayerProxy(Layer):
    """A later use of a shared layer: owns no parameters, borrows the
    master layer and applies ``forward_func``."""

    def __init__(self, master: torch.nn.Module, desc: SharedLayerDesc):
        super().__init__()
        object.__setattr__(self, "_master", master)  # not a sublayer
        self._forward_func = desc.forward_func
        self._attr = desc.shared_weight_attr

    @property
    def shared_weight(self):
        return getattr(self._master, self._attr)

    def forward(self, *args, **kwargs):
        if self._forward_func is not None:
            return self._forward_func(self._master, *args, **kwargs)
        return self._master(*args, **kwargs)


class _FuncLayer(Layer):
    """A bare callable in the layer list."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class _SparseLayerList(Layer):
    """The local layers under their global indices (``"3"``, ``"4"``, …):
    a rank's part of the reference's ``run_function`` list."""

    def __getitem__(self, i):
        return self._modules[str(i)]

    def __contains__(self, i):
        return str(i) in self._modules

    def indices(self) -> List[int]:
        return sorted(int(k) for k in self._modules)


def _module_signature(layer: torch.nn.Module):
    params = tuple((n, tuple(p.shape), str(p.dtype))
                   for n, p in layer.named_parameters())
    bufs = tuple((n, tuple(b.shape), str(b.dtype))
                 for n, b in layer.named_buffers() if b is not None)
    return (type(layer).__name__, params, bufs)


def _signature(entry):
    """What makes two entries of the layer list equal (module doc)."""
    if isinstance(entry, SharedLayerDesc):
        return ("shared", entry.layer_name, entry.layer_cls,
                repr(entry.inputs), repr(sorted(entry.kwargs.items())))
    if isinstance(entry, LayerDesc):
        return ("desc", entry.layer_cls, repr(entry.inputs),
                repr(sorted(entry.kwargs.items())))
    if isinstance(entry, torch.nn.Module):
        return ("layer",) + _module_signature(entry)
    return ("func", id(entry))


def _class_name(entry) -> str:
    if isinstance(entry, LayerDesc):
        return entry.layer_cls.__name__
    if isinstance(entry, torch.nn.Module):
        return type(entry).__name__
    return getattr(entry, "__name__", type(entry).__name__)


class PipelineLayer(Layer):
    """A pipeline model (upstream: ``pp_layers.PipelineLayer``): the flat
    list of ``LayerDesc`` / ``SharedLayerDesc`` / layers / callables,
    ``num_stages`` (or ``topology``'s ``pp``), ``loss_fn``,
    ``seg_method``, ``recompute_interval`` (the body layers of a stage run
    under activation checkpointing in groups of this many),
    ``num_virtual_pipeline_stages`` (chunks a stage, for the interleaved
    schedule) and ``freeze_buffers`` (buffers keep their values through
    training, as the reference's frozen state). This process builds the
    stage of its ``fleet`` pipeline rank when the world runs a pipeline of
    ``num_stages``, else every stage; ``device`` is where the layers are
    built (default: the running world's device, else the card)."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: Optional[int] = None,
                 freeze_buffers: bool = False, device=None):
        super().__init__()
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pp")
        self._num_stages = int(num_stages or 1)
        self._loss_fn = loss_fn
        self._seg_method = seg_method
        self._recompute_interval = int(recompute_interval)
        self._topology = topology
        self._freeze_buffers = bool(freeze_buffers)
        self._num_virtual_stages = int(num_virtual_pipeline_stages or 1)
        if self._num_virtual_stages < 1:
            raise ValueError("num_virtual_pipeline_stages must be >= 1")
        self._descs = list(layers)
        for d in self._descs:
            if not (isinstance(d, (LayerDesc, torch.nn.Module))
                    or callable(d)):
                raise TypeError(f"PipelineLayer: bad layer entry {d!r}")
        self._classify()
        self._stage_id = self._resolve_stage()
        self.device = self._resolve_device(device)
        self._build()

    # ---------------------------------------------------------------- layout
    def _body_candidates(self) -> Tuple[int, int]:
        """[start, stop) of the longest run of equal entries."""
        sigs = [_signature(d) for d in self._descs]
        best, i, n = (0, 0), 0, len(sigs)
        while i < n:
            j = i
            while j < n and sigs[j] == sigs[i]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        return best

    def _classify(self):
        start, stop = self._body_candidates()
        if self._seg_method.startswith("layer:"):
            cls_name = self._seg_method.split(":", 1)[1]
            idx = [i for i, d in enumerate(self._descs)
                   if _class_name(d) == cls_name]
            if idx:
                start, stop = idx[0], idx[-1] + 1
                sig0 = _signature(self._descs[start])
                for off in range(start + 1, stop):
                    if _signature(self._descs[off]) != sig0:
                        raise ValueError(
                            f"seg_method={self._seg_method!r}: layer at "
                            f"index {off} ({_class_name(self._descs[off])}) "
                            f"inside the [{start},{stop}) span is not "
                            f"identical to {cls_name}; the pipeline needs a "
                            "homogeneous body")
        n_body = stop - start
        chunks = self._num_stages * self._num_virtual_stages
        if chunks > 1 and (n_body == 0 or n_body % chunks != 0):
            raise ValueError(
                f"PipelineLayer: homogeneous body of {n_body} layers "
                f"(indices [{start},{stop})) is not divisible by "
                f"num_stages={self._num_stages} x "
                f"virtual={self._num_virtual_stages}; pad the block count "
                f"or change seg_method (got {self._seg_method!r})")
        self._body_range = (start, stop)

    @property
    def layers_per_stage(self) -> int:
        """Body layers a physical stage (over all its chunks)."""
        a, b = self._body_range
        return (b - a) // max(1, self._num_stages)

    @property
    def layers_per_chunk(self) -> int:
        """Body layers a virtual stage (chunk)."""
        return self.layers_per_stage // max(1, self._num_virtual_stages)

    def get_num_stages(self) -> int:
        return self._num_stages

    def get_num_virtual_stages(self) -> int:
        return self._num_virtual_stages

    def get_stage_from_index(self, index: int) -> int:
        """The physical stage whose chunk holds layer ``index``."""
        a, b = self._body_range
        if index < a:
            return 0
        if index >= b:
            return self._num_stages - 1
        return (index - a) // max(1, self.layers_per_chunk) \
            % self._num_stages

    def chunk_range(self, virtual_stage: int) -> Tuple[int, int]:
        """``[start, stop)`` of the layers virtual stage ``d`` runs (the
        first also runs ``pre``, the last ``post``)."""
        a, b = self._body_range
        last = self._num_stages * self._num_virtual_stages - 1
        kc = self.layers_per_chunk
        lo = 0 if virtual_stage == 0 else a + virtual_stage * kc
        hi = len(self._descs) if virtual_stage == last \
            else a + (virtual_stage + 1) * kc
        if a == b:  # no body (one stage): everything on stage 0
            lo, hi = 0, len(self._descs)
        return lo, hi

    def segment_describe(self) -> str:
        a, b = self._body_range
        return (f"pre[0:{a}] body[{a}:{b}]×{self._num_stages}stages "
                f"post[{b}:{len(self._descs)}]")

    @property
    def pre_layers(self) -> List[torch.nn.Module]:
        return [self.run_function[i] for i in range(self._body_range[0])
                if i in self.run_function]

    @property
    def body_layers(self) -> List[torch.nn.Module]:
        a, b = self._body_range
        return [self.run_function[i] for i in range(a, b)
                if i in self.run_function]

    @property
    def post_layers(self) -> List[torch.nn.Module]:
        return [self.run_function[i]
                for i in range(self._body_range[1], len(self._descs))
                if i in self.run_function]

    # ----------------------------------------------------------------- build
    def _resolve_stage(self):
        from ..fleet_base import fleet_state

        if (fleet_state.initialized and self._num_stages > 1
                and fleet_state.hcg.get_pipe_parallel_world_size()
                == self._num_stages):
            return fleet_state.hcg.get_stage_id()
        return None  # every stage in this process

    @staticmethod
    def _resolve_device(device):
        from ....framework.device import resolve_device
        from ...parallel import get_device, is_initialized

        if device is None and is_initialized():
            return get_device()
        return resolve_device(device)

    @property
    def stage_id(self) -> Optional[int]:
        """This process's stage, or None when it holds every stage."""
        return self._stage_id

    def local_virtual_stages(self) -> List[int]:
        """The virtual stages this process runs, in chunk order."""
        total = self._num_stages * self._num_virtual_stages
        if self._stage_id is None:
            return list(range(total))
        return [c * self._num_stages + self._stage_id
                for c in range(self._num_virtual_stages)]

    def _build(self):
        local = set()
        for d in self.local_virtual_stages():
            lo, hi = self.chunk_range(d)
            local.update(range(lo, hi))
        self._local = local
        # the first use of each shared key, and the layers it is shared by
        self._shared_first: Dict[str, int] = {}
        for i, desc in enumerate(self._descs):
            if isinstance(desc, SharedLayerDesc):
                self._shared_first.setdefault(desc.layer_name, i)
        run = _SparseLayerList()
        masters: Dict[str, torch.nn.Module] = {}
        ctx = torch.device(self.device)
        with ctx:
            for i, desc in enumerate(self._descs):
                if i not in local:
                    continue
                if isinstance(desc, SharedLayerDesc):
                    key = desc.layer_name
                    first = self._shared_first[key]
                    if key not in masters:
                        # the first use, or this stage's copy of it under
                        # the first use's name
                        masters[key] = self._descs[first].build_layer()
                        run.add_module(str(first), masters[key])
                    if i != first:
                        run.add_module(str(i), _SharedLayerProxy(
                            masters[key], desc))
                elif isinstance(desc, LayerDesc):
                    run.add_module(str(i), desc.build_layer())
                elif isinstance(desc, torch.nn.Module):
                    run.add_module(str(i), desc.to(self.device))
                else:
                    run.add_module(str(i), _FuncLayer(desc))
        self.run_function = run

    def shared_layers(self) -> Dict[str, Tuple[int, List[int]]]:
        """``{key: (index of the first use, [indices of every use])}`` for
        each ``SharedLayerDesc`` key."""
        out: Dict[str, Tuple[int, List[int]]] = {}
        for i, desc in enumerate(self._descs):
            if isinstance(desc, SharedLayerDesc):
                first, uses = out.get(desc.layer_name, (i, []))
                out[desc.layer_name] = (first, uses + [i])
        return out

    # --------------------------------------------------------------- forward
    def _run(self, i, x):
        layer = self.run_function[i]
        return layer(*x) if isinstance(x, tuple) else layer(x)

    def forward_chunk(self, x, virtual_stage: int):
        """Run virtual stage ``virtual_stage``'s layers on ``x``. Groups of
        ``recompute_interval`` body layers run under activation
        checkpointing when training with gradients on."""
        lo, hi = self.chunk_range(virtual_stage)
        a, b = self._body_range
        k = self._recompute_interval
        i = lo
        while i < hi:
            if (k > 0 and a <= i < b and self.training
                    and torch.is_grad_enabled()):
                j = min(i + k, b, hi)

                def group(h, i0=i, i1=j):
                    for t in range(i0, i1):
                        h = self._run(t, h)
                    return h

                x = torch.utils.checkpoint.checkpoint(group, x,
                                                      use_reentrant=False)
                i = j
                continue
            x = self._run(i, x)
            i += 1
        return x

    def forward(self, *args):
        """The local chunks in order: the whole sequential model when this
        process holds every stage."""
        x = args[0] if len(args) == 1 else args
        for d in self.local_virtual_stages():
            x = self.forward_chunk(x, d)
        return x

    @contextlib.contextmanager
    def frozen_buffers(self, snapshot):
        """Load ``snapshot`` (``{name: tensor}``) into the buffers for the
        block and restore it after: buffer updates inside are dropped."""
        bufs = dict(self.named_buffers())
        with torch.no_grad():
            for n, v in snapshot.items():
                bufs[n].copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for n, v in snapshot.items():
                    bufs[n].copy_(v)
