"""The MoE layer, after
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``: ``MoELayer``,
``ExpertFFN`` and the routing primitives ``count_by_gate``,
``limit_by_capacity`` and ``gshard_dispatch``.

Two ways to run the experts at one rank, as in the reference:

* the dense GShard path: dispatch and combine one-hots ``[T, E, C]`` over
  a capacity ``C`` a expert, ``einsum`` into ``[E, C, H]``, each expert
  once over its ``C`` rows, ``einsum`` back;
* the ragged path (``ragged.py``): each expert only over the pairs routed
  to it, on the grouped matmul kernel (#13). ``use_ragged=None`` takes it
  when every expert is an ``ExpertFFN`` with one activation;
  ``dropless=True`` drops nothing at capacity (ragged only).

Expert parallelism: the expert axis is the mesh axis ``axis_name``
(default ``"dp"``); at ep > 1 the layer is one process a rank, and its
answer is the reference's global program, the same layer without a mesh
on the global batch (every rank's tokens, rank-major). So:

* rank ``r`` keeps experts ``[r·E/ep, (r+1)·E/ep)`` under their global
  names (``experts.{e}.…``) and frees the rest; each local expert
  parameter carries ``is_expert`` and ``expert_group``. The mesh must be
  set before the layer is built, a forward under another ep degree
  raises, and an E that ep does not divide raises (the reference falls
  back to replicated experts there);
* the capacity is the global token count's, and the slots are numbered as
  the reference's one cumsum over the global token order, every choice 0
  before choice 1: each rank's per-choice per-expert counts ``[k, E]`` are
  gathered, and its slots offset by the lower ranks' counts of the same
  choice plus every rank's counts of the earlier choices. Each rank fills
  only its own slots of ``[E, C, H]``;
* an ``all_to_all`` split on E sends each expert's rows to its owner,
  which sums the ep chunks (the slots are disjoint, so the sum is a
  gather); the local experts run (``ExpertFFN`` experts through
  ``ragged_dot``, #13, over their ``E/ep`` groups of ``C`` rows; others
  one call an expert); an ``all_gather`` of their ``[E/ep, C, H]`` rows
  lets each rank combine its own tokens. Padded slots have combine weight
  0, so they reach neither the output nor a gradient. The collectives are
  ``distributed.collective``'s autograd functions;
* ``use_ragged=True`` and ``dropless=True`` raise there, as in the
  reference. After the backward a local expert's gradient is the sum over
  ranks of each rank's mean loss's: ep times the global one. The fleet
  optimizer, ``fused_allreduce_gradients`` and ``DataParallel`` leave the
  expert parameters out of the dp average and divide them by ep.

Gradients reach the input, the gate and every expert parameter through
plain autograd.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .....distributed import parallel as _parallel
from .....distributed.collective import all_gather, fcollectives
from .....nn import functional as F
from .....nn.common import Linear
from .....nn.layer import Layer, LayerList
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .ragged import moe_ragged_ffn, padded_flops_fraction
from .....ops.cuda.grouped_matmul import ragged_dot

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


def _expert_group(axis_name):
    """The group of ``axis_name`` on the current mesh (this rank's)."""
    import torch.distributed as dist

    from .....distributed.topology import Group

    mesh = _parallel.current_mesh()
    pg = mesh.get_group(axis_name)
    return Group(dist.get_process_group_ranks(pg), axis_name=axis_name,
                 rank=mesh.get_local_rank(axis_name), process_group=pg)


class MoELayer(Layer):
    """Mixture-of-experts layer (the reference's signature: the global
    expert list and a gate, a gate config dict or None for
    ``GShardGate``).

    ``experts``: structurally identical layers. ``capacity_factor`` None
    takes the gate's ``(train, eval)`` factors. After each ragged forward
    ``last_padded_fraction`` holds the share of the dense path's expert
    rows that would have been padding. At ep > 1 (see the module doc)
    ``experts`` holds this rank's experts under their global indices, and
    ``last_drops`` after each forward is this rank's ``[T, k]`` bool of the
    pairs dropped at capacity (expert -1 pairs not counted)."""

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
        self.last_drops = None
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
        self.ep_degree = _expert_parallel_degree(axis_name)
        self._ep_group = None
        if self.ep_degree > 1:
            self._shard_experts()

    def _shard_experts(self):
        """Keep this rank's experts (global indices, global names), free
        the rest, mark the kept parameters and give the gate the group."""
        ep = self.ep_degree
        if self.num_expert % ep:
            raise ValueError(f"MoELayer: {self.num_expert} experts do not "
                             f"divide over {self.axis_name}={ep} ranks")
        group = _expert_group(self.axis_name)
        per = self.num_expert // ep
        mine = range(group.rank * per, (group.rank + 1) * per)
        for i in range(self.num_expert):
            if i not in mine:
                del self.experts._modules[str(i)]
        for p in self.experts.parameters():
            p.is_expert = True
            p.expert_group = group
        self._ep_group = self.gate._ep_group = group

    def _uniform_ffn(self) -> bool:
        """Every (local) expert an ``ExpertFFN`` of one activation."""
        return (all(isinstance(e, ExpertFFN) for e in self.experts)
                and len({e.activation for e in self.experts}) == 1)

    def _ragged_active(self) -> bool:
        if self.use_ragged is False:
            return False
        eligible = self._uniform_ffn() and self._ep_group is None
        if (self.use_ragged or self.dropless) and not eligible:
            raise ValueError("use_ragged=True/dropless=True need ExpertFFN "
                             "experts with one shared activation and no "
                             "expert-parallel sharding (the dense EP path "
                             "drops tokens at capacity)")
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

    def _global_slots(self, idx):
        """This rank's pairs' slots in the global order: ``(slot [T, k],
        keep [T, k], capacity)``; ``keep`` is False for expert -1 and past
        the capacity of the global token count."""
        grp, e = self._ep_group, self.num_expert
        t, k = idx.shape
        one = _one_hot(idx, e)                                  # [T, k, E]
        mine = torch.cat([one.sum(0, dtype=torch.int64).reshape(-1),
                          torch.full((1,), t, dtype=torch.int64,
                                     device=idx.device)])
        every = torch.stack(all_gather([], mine, grp))    # [ep, k*E + 1]
        counts = every[:, :-1].reshape(grp.nranks, k, e)
        capacity = self._capacity(int(every[:, -1].sum()))
        per_choice = counts.sum(0)                                 # [k, E]
        offset = (torch.cumsum(per_choice, 0) - per_choice
                  + counts[:grp.rank].sum(0))                      # [k, E]
        pos = offset[None] + torch.cumsum(one, 0) - 1
        slot = (pos * one).sum(-1)                                 # [T, k]
        keep = (idx >= 0) & (slot < capacity)
        return slot, keep, capacity

    def _local_experts(self, rows, capacity):
        """The local experts over their ``[E/ep * C, H]`` rows."""
        local = list(self.experts)
        el = len(local)
        if self._uniform_ffn():
            def stack(leaf):
                return torch.stack([x.get_parameter(leaf) for x in local])

            gs = torch.full((el,), capacity, dtype=torch.int32,
                            device=rows.device)
            w1, w2 = stack("fc1.weight"), stack("fc2.weight")
            hid = ragged_dot(rows, w1, gs).view(el, capacity, -1) \
                + stack("fc1.bias")[:, None, :]
            hid = _ACT_FNS[local[0].activation](hid).reshape(
                el * capacity, -1)
            out = ragged_dot(hid, w2, gs).view(el, capacity, -1) \
                + stack("fc2.bias")[:, None, :]
            return out.reshape(el * capacity, -1)
        per = rows.view(el, capacity, -1)
        return torch.cat([x(per[i]) for i, x in enumerate(local)])

    def _ep_forward(self, xt, val, idx):
        grp, e = self._ep_group, self.num_expert
        t, h = xt.shape
        k = idx.shape[1]
        slot, keep, capacity = self._global_slots(idx)
        self.last_drops = (idx >= 0) & ~keep
        dump = e * capacity  # one row past the slots for the unkept pairs
        dest = torch.where(keep, idx.long() * capacity + slot,
                           torch.full_like(slot, dump))
        pairs = xt[:, None, :].expand(t, k, h).reshape(t * k, h)
        rows = torch.zeros((dump + 1, h), dtype=xt.dtype,
                           device=xt.device).index_add(
            0, dest.reshape(-1), pairs)[:dump]
        # each expert's rows to its owner; the ep chunks' slots are
        # disjoint, so their sum is a gather
        got = fcollectives.all_to_all(rows, grp, 0, 0)
        mine = got.view(grp.nranks, -1, h).sum(0)
        out = self._local_experts(mine, capacity)
        out = fcollectives.all_gather(out, grp, axis=0)          # [E*C, H]
        out = torch.cat([out, out.new_zeros((1, h))])
        w = torch.where(keep, val, torch.zeros_like(val)).to(out.dtype)
        y = torch.zeros((t, h), dtype=out.dtype, device=out.device)
        for j in range(k):
            y = y + w[:, j:j + 1] * out[dest[:, j]]
        return y

    def forward(self, inp):
        ep = _expert_parallel_degree(self.axis_name)
        if ep != self.ep_degree:
            raise TypeError(f"MoELayer: built at expert parallelism "
                            f"{self.ep_degree}, run on a mesh whose expert "
                            f"axis {self.axis_name} is {ep}: build the "
                            "layer after the mesh is set")
        xt = inp.reshape(-1, inp.shape[-1])
        val, idx = self.gate(xt)[:2]
        if self._ep_group is not None:
            self._ragged_active()  # raises for use_ragged / dropless
            return self._ep_forward(xt, val, idx).reshape(inp.shape)
        capacity = self._capacity(xt.shape[0])
        run = (self._ragged_forward if self._ragged_active()
               else self._dense_forward)
        return run(xt, val, idx, capacity).reshape(inp.shape)
