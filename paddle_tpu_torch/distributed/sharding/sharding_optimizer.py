"""The sharded optimizer, ZeRO stages 1-3 (after
``paddle_tpu/distributed/sharding/sharding_optimizer.py``).

The reference places each optimizer state array sharded over the mesh's
``sharding`` axis and lets XLA partition the update. Here each rank is a
process, so the wrapper does by hand what that placement means:

- Every parameter is cut along the dim that ``add_sharding_axis`` picks
  (:func:`sharding_dim`: the first dim the group's size divides; none,
  and the parameter stays whole on every rank). Rank ``r`` of ``n`` owns
  block ``r`` of that dim, its *slice*. The wrapped optimizer is given the
  slices in place of the parameters, so its state (AdamW's two moments,
  f32 master copies) is slice-sized: each rank keeps and updates only its
  slice of every state.
- ``os`` (stage 1): the gradients are averaged whole over the group (in
  buckets), and each rank steps its slice on its block of them.
  ``os_g`` (stage 2): they are reduce-scattered, so each rank reduces
  only its slice's block and the whole gradient is dropped. ``p_g_os``
  (stage 3): as ``os_g``, and between steps each rank also holds only its
  slice of every parameter; :class:`~.group_sharded.GroupShardedModel`
  all-gathers the whole parameters before the forward, and they stay
  whole through the backward until the step.
- After the update every slice is all-gathered (in buckets) into the
  whole parameter, so every rank holds whole parameters again (``os``,
  ``os_g``).
- With a ``dp_group`` the gradients are averaged over it as well (the
  ranks of a ``dp`` x ``sharding`` layout see four shares of the batch).
  It defaults to fleet's ``dp`` group only when the sharding group is
  fleet's ``sharding`` group: any other group may hold the same ranks.

A slice carries ``is_sharding_slice``, so the hybrid clip sums its norm
over the group. Ranks must hold the same parameters to start: the group's
first rank broadcasts them at wrap.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..collective import ReduceOp, all_gather, reduce_scatter
from ..parallel import allreduce_buckets, buckets, get_group, is_initialized

__all__ = ["ShardedOptimizer", "DygraphShardingOptimizer", "sharding_dim"]

LEVELS = ("os", "os_g", "p_g_os")


def sharding_dim(shape, degree: int) -> Optional[int]:
    """The dim a ``degree``-way sharding cuts a tensor of ``shape`` (this
    rank's, after any ``mp`` split) along: the first one ``degree``
    divides, None when none does (the tensor stays whole)."""
    if degree <= 1:
        return None
    for i, d in enumerate(shape):
        if d >= degree and d % degree == 0:
            return i
    return None


def _fleet_group(kind):
    """fleet's ``kind`` group (``"sharding"`` / ``"dp"``) when fleet laid
    the world out with that degree above 1, else None."""
    from ..fleet.fleet_base import fleet_state

    if not fleet_state.initialized:
        return None
    hcg = fleet_state.hcg
    if kind == "sharding":
        g = hcg.get_sharding_parallel_group()
    else:
        g = hcg.get_data_parallel_group()
    return g if g.nranks > 1 else None


class _Entry:
    __slots__ = ("name", "param", "dim", "width", "slice", "full_shape")

    def __init__(self, name, param, dim, width, sl, full_shape):
        self.name, self.param, self.dim, self.width = name, param, dim, width
        self.slice, self.full_shape = sl, full_shape


class ShardedOptimizer:
    """Wraps a port optimizer (built over the model's parameters) for
    ``level`` over ``group`` (None: fleet's ``sharding`` group, else the
    world). See the module doc."""

    def __init__(self, inner, group=None, level: str = "os",
                 offload: bool = False, dp_group=None,
                 bucket_mb: float = 25):
        if level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, got "
                             f"{level!r}")
        if offload:
            raise ValueError("offload=True is not ported: the optimizer "
                             "state stays on the card")
        if not is_initialized():
            from ..parallel import init_parallel_env

            init_parallel_env()
        self._inner = inner
        self._level = level
        fleet_sharding = _fleet_group("sharding")
        self._group = group or fleet_sharding or get_group()
        if dp_group is None and fleet_sharding is not None and \
                self._group.ranks == fleet_sharding.ranks:
            # fleet's dp group is orthogonal to its sharding group only
            dp_group = _fleet_group("dp")
        self._dp_group = dp_group
        self.bucket_mb = bucket_mb
        self.last_calls = 0
        self._gathered = True
        self._entries = []
        self._shard(inner)
        self._distribute_clip(inner)

    def _distribute_clip(self, inner):
        """A plain global-norm clip of the wrapped optimizer sums its slices'
        norms over the group (the hybrid clip)."""
        from ...nn.clip import ClipGradByGlobalNorm
        from ..fleet.fleet_base import fleet_state
        from ..fleet.meta_optimizers.dygraph_optimizer import \
            HybridParallelClipGrad

        if type(inner._grad_clip) is ClipGradByGlobalNorm:
            inner._grad_clip = HybridParallelClipGrad(
                inner._grad_clip,
                fleet_state.hcg if fleet_state.initialized else None,
                sharding_group=self._group)

    # ---------------------------------------------------------- placement
    @torch.no_grad()
    def _shard(self, inner):
        from ..collective import broadcast

        g = self._group
        n, r = g.nranks, g.rank
        slices = []
        for i, (name, p) in enumerate(zip(inner._names, inner._params)):
            name = name or f"param_{i}"
            for grp in (g, self._dp_group):
                if grp is not None and grp.nranks > 1:
                    broadcast(p.data, grp.ranks[0], group=grp)
            dim = sharding_dim(p.shape, n) if p.requires_grad else None
            if dim is None:
                self._entries.append(_Entry(name, p, None, None, p,
                                            tuple(p.shape)))
                slices.append(p)
                continue
            w = p.shape[dim] // n
            sl = p.detach().narrow(dim, r * w, w)
            if self._level == "p_g_os":
                sl = sl.clone()  # its own storage: the parameter's rest
            sl.requires_grad_(True)
            sl.is_sharding_slice = True
            if getattr(p, "is_distributed", False) is True:
                sl.is_distributed = True
            self._entries.append(_Entry(name, p, dim, w, sl,
                                        tuple(p.shape)))
            slices.append(sl)
        inner._params = slices
        if self._level == "p_g_os":
            self._release()

    @property
    def sharded(self):
        """[(name, dim, slice)] of the parameters that are cut."""
        return [(e.name, e.dim, e.slice) for e in self._entries
                if e.dim is not None]

    def _cut(self):
        return [e for e in self._entries if e.dim is not None]

    @torch.no_grad()
    def _release(self):
        """Stage 3: each cut parameter holds only its slice."""
        for e in self._cut():
            e.param.data = e.slice.data
        self._gathered = False

    @torch.no_grad()
    def _gather(self, into_params: bool):
        """All-gather every slice, in buckets: into each whole parameter in
        place (``into_params``), or into a new whole tensor that becomes
        the parameter's data (stage 3)."""
        g = self._group
        calls = 0
        for bucket in buckets([e.slice for e in self._cut()],
                              self.bucket_mb):
            ents = [e for e in self._cut() if any(e.slice is s
                                                  for s in bucket)]
            flat = torch.cat([e.slice.reshape(-1) for e in ents])
            parts = all_gather([], flat, group=g)
            calls += 1
            for e in ents:
                if not into_params:
                    e.param.data = torch.empty(
                        e.full_shape, dtype=e.slice.dtype,
                        device=e.slice.device)
            for j, part in enumerate(parts):
                off = 0
                for e in ents:
                    k = e.slice.numel()
                    if into_params and j == g.rank:
                        off += k
                        continue
                    e.param.data.narrow(e.dim, j * e.width, e.width).copy_(
                        part[off:off + k].view(e.slice.shape))
                    off += k
        if not into_params:
            self._gathered = True
        return calls

    def gather_params(self):
        """Stage 3: make every parameter whole (a no-op when it is)."""
        if self._level == "p_g_os" and not self._gathered:
            self.last_calls += self._gather(into_params=False)

    # -------------------------------------------------------------- step
    @torch.no_grad()
    def _reduce_grads(self):
        g = self._group
        n, r = g.nranks, g.rank
        calls = 0
        whole = [e.param.grad for e in self._entries
                 if e.param.grad is not None
                 and (self._level == "os" or e.dim is None)]
        calls += allreduce_buckets(whole, g, "avg", self.bucket_mb)
        if self._level == "os":
            for e in self._cut():
                gr = e.param.grad
                e.slice.grad = None if gr is None else gr.narrow(
                    e.dim, r * e.width, e.width)
        else:
            cut = [e for e in self._cut() if e.param.grad is not None]
            for bucket in buckets([e.param.grad for e in cut],
                                  self.bucket_mb):
                ents = [e for e in cut if any(e.param.grad is t
                                              for t in bucket)]
                per_rank = [torch.cat([
                    e.param.grad.narrow(e.dim, j * e.width, e.width)
                    .reshape(-1) for e in ents]) for j in range(n)]
                mine = torch.empty_like(per_rank[0])
                reduce_scatter(mine, per_rank, op=ReduceOp.SUM, group=g)
                mine.div_(n)
                calls += 1
                off = 0
                for e in ents:
                    k = e.slice.numel()
                    e.slice.grad = mine[off:off + k].view(e.slice.shape)
                    off += k
                    e.param.grad = None  # the whole gradient is dropped
        if self._dp_group is not None:
            calls += allreduce_buckets(
                [e.slice.grad for e in self._entries
                 if e.slice.grad is not None], self._dp_group, "avg",
                self.bucket_mb)
        return calls

    def step(self):
        self.gather_params()
        calls = self._reduce_grads()
        self._inner.step()
        if self._level == "p_g_os":
            self._release()
        else:
            calls += self._gather(into_params=True)
        self.last_calls = calls

    def clear_grad(self, set_to_zero=False):
        for e in self._entries:
            if e.param.grad is not None:
                if set_to_zero:
                    e.param.grad.zero_()
                else:
                    e.param.grad = None
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    # ------------------------------------------------------------- state
    def state_dict(self):
        """This rank's state: each cut parameter's entries are its slices
        (the wrapped optimizer's ``state_dict``)."""
        return self._inner.state_dict()

    def shard_info(self) -> Dict[str, tuple]:
        """``{state key: (offset, global shape)}`` of every sliced entry
        of :meth:`state_dict`, for a sharded checkpoint."""
        r = self._group.rank
        info = {}
        for e in self._cut():
            off = [0] * len(e.full_shape)
            off[e.dim] = r * e.width
            for key in self._state_keys(e):
                info[key] = (tuple(off), e.full_shape)
        return info

    def sharded_state_dict(self):
        """:meth:`state_dict` with each sliced entry as a
        ``checkpoint.Shard`` (its offset and global shape): what every
        member passes to ``save_state_dict(..., group=)``."""
        from ..checkpoint import Shard

        info = self.shard_info()
        return {k: Shard(v, *info[k]) if k in info else v
                for k, v in self.state_dict().items()}

    def _state_keys(self, e):
        inner = self._inner
        keys = [f"{e.name}.{k}" for k in
                inner._accumulators.get(id(e.slice), {})]
        if id(e.slice) in inner._master_weights:
            keys.append(f"{e.name}.master")
        return keys

    @torch.no_grad()
    def gathered_state_dict(self):
        """The whole state on every rank (a collective: every member
        calls it): each sliced entry all-gathered along its dim."""
        out = dict(self.state_dict())
        for e in self._cut():
            for key in self._state_keys(e):
                parts = all_gather([], out[key].contiguous(),
                                   group=self._group)
                out[key] = torch.cat(parts, dim=e.dim)
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load a whole state (``gathered_state_dict``'s, or a checkpoint's
        assembled one): each rank keeps its slice of every sliced entry;
        a slice-shaped entry is taken as this rank's own."""
        r = self._group.rank
        local = dict(state)
        for e in self._cut():
            for key in [f"{e.name}.{k}" for k in
                        self._inner.init_state(torch.zeros(1))] + [
                            f"{e.name}.master"]:
                v = local.get(key)
                if isinstance(v, torch.Tensor) and tuple(v.shape) == \
                        e.full_shape:
                    local[key] = v.narrow(e.dim, r * e.width, e.width)
        self._inner.set_state_dict(local)

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner"], item)


class DygraphShardingOptimizer(ShardedOptimizer):
    """Stage 1 under the reference's constructor ``(optimizer, hcg)``:
    the group is ``hcg``'s ``sharding`` group and its ``dp`` group also
    averages the gradients."""

    def __init__(self, optimizer, hcg=None, **kwargs):
        if hcg is not None:
            kwargs.setdefault("group", hcg.get_sharding_parallel_group())
            dp = hcg.get_data_parallel_group()
            kwargs.setdefault("dp_group", dp if dp.nranks > 1 else None)
        super().__init__(optimizer, level="os", **kwargs)
        self._hcg = hcg
