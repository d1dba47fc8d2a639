"""The MoE layer, after
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``: ``MoELayer``,
``ExpertFFN`` and the routing primitives ``count_by_gate``,
``limit_by_capacity`` and ``gshard_dispatch``.

Two ways to run the experts, as in the reference:

* the dense GShard path: dispatch and combine one-hots ``[T, E, C]`` over
  a capacity ``C`` a expert, ``einsum`` into ``[E, C, H]``, each expert
  once over its ``C`` rows, ``einsum`` back;
* the ragged path (``ragged.py``): each expert only over the pairs routed
  to it, on the grouped matmul kernel (#13). ``use_ragged=None`` takes it
  when every expert is an ``ExpertFFN`` with one activation;
  ``dropless=True`` drops nothing at capacity (ragged only).

Gradients reach the input, the gate and every expert parameter through
plain autograd. Expert parallelism is not ported: with a mesh whose
expert axis (``axis_name``) is larger than one, ``forward`` raises
``TypeError`` rather than run every expert on one rank.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .....distributed import parallel as _parallel
from .....nn import functional as F
from .....nn.common import Linear
from .....nn.layer import Layer, LayerList
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .ragged import moe_ragged_ffn, padded_flops_fraction

__all__ = ["MoELayer", "ExpertFFN", "gshard_dispatch", "count_by_gate",
           "limit_by_capacity"]

_ACT_FNS = {"relu": F.relu, "gelu": F.gelu, "silu": F.silu}


class ExpertFFN(Layer):
    """The canonical two-linear expert, ``fc2(act(fc1(x)))``. A layer whose
    experts are all ``ExpertFFN`` with one activation takes the ragged
    path."""

    def __init__(self, d_model: int, d_hidden: int, activation: str = "gelu",
                 *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype)
        if activation not in _ACT_FNS:
            raise ValueError(f"unsupported ExpertFFN activation "
                             f"{activation!r}")
        self.fc1 = Linear(d_model, d_hidden, device=device, dtype=dtype)
        self.fc2 = Linear(d_hidden, d_model, device=device, dtype=dtype)
        self.activation = activation

    def forward(self, x):
        return self.fc2(_ACT_FNS[self.activation](self.fc1(x)))


def _one_hot(idx, n):
    """int32 ``[..., n]``; an index of -1 gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def count_by_gate(topk_idx, num_expert: int):
    """Assignments per expert ``[E]`` (int32)."""
    return _one_hot(topk_idx.reshape(-1), num_expert).sum(
        0, dtype=torch.int32)


def limit_by_capacity(topk_idx, num_expert: int, capacity: int):
    """Mask assignments past each expert's capacity, in flattened order.
    Returns ``(masked_idx, position)``: -1 where masked, and each
    assignment's 0-based rank within its expert."""
    idx = topk_idx.reshape(-1)
    one = _one_hot(idx, num_expert)
    pos = (torch.cumsum(one, 0) * one).sum(-1) - 1
    masked = torch.where(pos < capacity, idx, torch.full_like(idx, -1))
    return masked.reshape(topk_idx.shape), pos.reshape(topk_idx.shape)


def gshard_dispatch(gate_val, gate_idx, num_expert: int, capacity: int):
    """Dispatch one-hot and combine weights, both ``[T, E, C]`` in the gate
    values' dtype, from top-k ``[T, k]`` gate outputs. Slots are given
    choice by choice (every choice-0 first), each in token order; a pair
    past its expert's capacity, or of expert -1, is dropped."""
    t, k = gate_idx.shape
    dt, dev = gate_val.dtype, gate_val.device
    dispatch = torch.zeros((t, num_expert, capacity), dtype=dt, device=dev)
    combine = torch.zeros_like(dispatch)
    running = torch.zeros((num_expert,), dtype=torch.int32, device=dev)
    for j in range(k):
        one = _one_hot(gate_idx[:, j], num_expert)
        pos = running[None, :] + torch.cumsum(one, 0) - 1
        slot = (pos * one).sum(-1)
        keep = (slot < capacity)[:, None, None].to(dt)
        slot_oh = torch.nn.functional.one_hot(
            slot.clamp(0, capacity - 1).long(), capacity).to(dt)
        oh = one.to(dt)[..., None] * slot_oh[:, None, :] * keep
        dispatch = dispatch + oh
        combine = combine + oh * gate_val[:, j][:, None, None]
        running = running + one.sum(0, dtype=torch.int32)
    return dispatch, combine


def _expert_parallel_degree(axis_name):
    """The size of ``axis_name`` on the current mesh (1 without a mesh)."""
    mesh = _parallel.current_mesh()
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis_name)])


class MoELayer(Layer):
    """Mixture-of-experts layer (the reference's signature: the expert
    list and a gate, a gate config dict or None for ``GShardGate``).

    ``experts``: structurally identical layers. ``capacity_factor`` None
    takes the gate's ``(train, eval)`` factors. After each ragged forward
    ``last_padded_fraction`` holds the share of the dense path's expert
    rows that would have been padding."""

    def __init__(self, d_model: int, experts: Sequence[torch.nn.Module],
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0, capacity_factor=None,
                 axis_name: str = "dp", use_ragged: Optional[bool] = None,
                 dropless: bool = False, **kwargs):
        super().__init__()
        self.d_model = d_model
        self.experts = LayerList(list(experts))
        self.num_expert = len(self.experts)
        self.capacity_factor = (None if capacity_factor is None
                                else float(capacity_factor))
        self.axis_name = axis_name
        self.use_ragged = use_ragged
        self.dropless = bool(dropless)
        if self.dropless and use_ragged is False:
            raise ValueError("dropless routing requires the ragged path")
        self.last_padded_fraction: Optional[float] = None
        if gate is None or isinstance(gate, dict):
            cfg = gate or {}
            cls = {"gshard": GShardGate, "switch": SwitchGate,
                   "naive": NaiveGate}[cfg.get("type", "gshard")]
            ref = next(self.experts[0].parameters())
            gate = cls(d_model, self.num_expert, topk=cfg.get("top_k", 2),
                       device=ref.device, dtype=ref.dtype)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate, got {type(gate)}")
        self.gate = gate
        sig = [tuple((n, tuple(p.shape)) for n, p in e.named_parameters())
               for e in self.experts]
        if any(s != sig[0] for s in sig):
            raise ValueError("MoELayer experts must be structurally "
                             "identical")

    def _ragged_active(self) -> bool:
        if self.use_ragged is False:
            return False
        eligible = (all(isinstance(e, ExpertFFN) for e in self.experts)
                    and len({e.activation for e in self.experts}) == 1)
        if (self.use_ragged or self.dropless) and not eligible:
            raise ValueError("use_ragged=True/dropless=True need ExpertFFN "
                             "experts with one shared activation")
        return eligible

    def _capacity(self, t: int) -> int:
        factor = self.capacity_factor
        if factor is None:
            cap = getattr(self.gate, "capacity", (1.2, 2.4))
            factor = cap[0] if self.training else cap[1]
        return max(1, int(float(factor) * self.gate.top_k * t
                          / self.num_expert))

    def _ragged_forward(self, xt, val, idx, capacity):
        def stack(leaf):
            return torch.stack([e.get_parameter(leaf) for e in self.experts])

        self.last_padded_fraction = padded_flops_fraction(
            self.num_expert, capacity, xt.shape[0], self.gate.top_k)
        return moe_ragged_ffn(
            xt, idx, val, stack("fc1.weight"), stack("fc1.bias"),
            stack("fc2.weight"), stack("fc2.bias"),
            _ACT_FNS[self.experts[0].activation],
            None if self.dropless else capacity)

    def _dense_forward(self, xt, val, idx, capacity):
        dispatch, combine = gshard_dispatch(val, idx, self.num_expert,
                                            capacity)
        expert_in = torch.einsum("tec,th->ech", dispatch, xt)
        expert_out = torch.stack([expert(expert_in[e]) for e, expert
                                  in enumerate(self.experts)])
        return torch.einsum("tec,ech->th", combine, expert_out)

    def forward(self, inp):
        ep = _expert_parallel_degree(self.axis_name)
        if ep > 1:
            raise TypeError(f"MoELayer: expert parallelism ({self.axis_name}"
                            f"={ep} on the mesh) is not ported; run it on "
                            "a mesh whose expert axis is 1")
        xt = inp.reshape(-1, inp.shape[-1])
        val, idx = self.gate(xt)[:2]
        capacity = self._capacity(xt.shape[0])
        run = (self._ragged_forward if self._ragged_active()
               else self._dense_forward)
        return run(xt, val, idx, capacity).reshape(inp.shape)
