"""The hybrid-parallel optimizer glue (after
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer.py``).

One process a rank, so what the reference gets from one SPMD program is
communication here:

- :class:`HybridParallelOptimizer` wraps the user's optimizer. Before the
  inner step it sums over the ``mp`` group the gradients of the
  sequence-parallel parameters (``mark_as_sequence_parallel_parameter``:
  replicated, but each ``mp`` rank saw only its slice of the sequence, so
  each holds a part of the gradient), as upstream Paddle's optimizer
  does. The other replicated parameters' gradients are whole and equal on
  every ``mp`` rank already (the mp layers' ``f`` / ``g`` conjugates
  reduce the activations' gradients), so they are left as they are, as
  the reference's one SPMD program leaves them. It then averages every
  gradient over the ``dp`` group in buckets
  (``fused_allreduce_gradients``), since each rank's gradients are those
  of its own share of the batch; an expert-parallel ``MoELayer``'s expert
  parameters are left out of that average and divided by ep (each rank
  holds other experts, whose gradient is already the sum over ranks). A sharded inner optimizer reduces its
  gradients itself, so then the ``dp`` average is left to it. Averaging
  gradients that ``DataParallel.apply_collective_grads`` already averaged
  gives them back unchanged (equal values), at the cost of the calls;
  ``fleet.distributed_model`` returns the model itself at ``dp > 1``, so
  on the fleet path this step is the one average.
- :class:`HybridParallelClipGrad` replaces a plain
  ``ClipGradByGlobalNorm``: each rank sums the squares of its gradients by
  kind, sums the ``mp``-split ones over ``mp``, the sharded slices over
  ``sharding``, and the total over ``pp``, so every rank scales by the
  same global norm. A tied weight that several pipeline stages hold
  counts once: its copies (``is_firstly_shared`` False) are left out.
- :class:`HybridParallelGradScaler` takes ``found_inf`` as the maximum
  over the world, so every rank skips the same steps.
- :class:`GradientMergeOptimizer`, :class:`LocalSGDOptimizer` and
  :class:`DGCMomentumOptimizer` are the reference's wrappers over the
  port's eager optimizer.
"""
from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm, _scale_for
from ...collective import ReduceOp, all_reduce
from ...parallel import get_world_size
from ...sharding.sharding_optimizer import (DygraphShardingOptimizer,
                                            ShardedOptimizer)
from ..utils.hybrid_parallel_util import fused_allreduce_gradients

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "HybridParallelGradScaler", "DygraphShardingOptimizer",
           "GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer"]


def _innermost(opt):
    """The optimizer under any wrappers (the one whose ``step`` reads
    ``_grad_clip``)."""
    while True:
        nxt = opt.__dict__.get("_inner", opt.__dict__.get("_inner_opt"))
        if nxt is None:
            return opt
        opt = nxt


def _distributed(p) -> bool:
    return getattr(p, "is_distributed", False) is True


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self.bucket_mb = (strategy.fuse_grad_size_in_MB
                          if strategy is not None else 25)
        self.last_buckets = 0
        inner = _innermost(optimizer)
        # only the exact base class: a subclass that overrides the norm
        # (the MoE clip) owns its computation
        if type(inner._grad_clip) is ClipGradByGlobalNorm:
            inner._grad_clip = HybridParallelClipGrad(inner._grad_clip, hcg)

    def _params(self):
        return _innermost(self._inner_opt)._parameter_list()

    def _sync_replicated_grads(self):
        if self._hcg is None or get_world_size() <= 1:
            return
        mp = self._hcg.get_model_parallel_group()
        if mp.nranks <= 1:
            return
        for p in self._params():
            if (getattr(p, "sequence_parallel", False)
                    and not _distributed(p) and p.grad is not None):
                all_reduce(p.grad, op=ReduceOp.SUM, group=mp)

    def _sync_dp_grads(self):
        if (self._hcg is None or get_world_size() <= 1
                or self._hcg.get_data_parallel_world_size() <= 1
                or isinstance(self._inner_opt, ShardedOptimizer)):
            self.last_buckets = 0
            return
        self.last_buckets = fused_allreduce_gradients(
            self._params(), self._hcg, self.bucket_mb)

    def step(self):
        self._sync_replicated_grads()
        self._sync_dp_grads()
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)


class HybridParallelClipGrad:
    """The global-norm clip across ranks (see the module doc). A gradient
    of a parameter with ``is_distributed`` counts once per ``mp`` rank, a
    pipeline copy of a tied weight (``is_firstly_shared`` False) not at
    all, a sharded optimizer's slice (``is_sharding_slice``) once per rank
    of the sharding group (``sharding_group``, else ``hcg``'s), the rest
    once."""

    def __init__(self, clip: ClipGradByGlobalNorm, hcg=None,
                 sharding_group=None):
        self._hcg = hcg
        self._sharding_group = sharding_group
        self.clip_norm = clip.clip_norm

    def _groups(self):
        """(mp, sharding, pp) groups; None where there is none."""
        hcg = self._hcg
        sh = self._sharding_group
        if hcg is None:
            return None, sh, None
        return (hcg.get_model_parallel_group(),
                sh if sh is not None else hcg.get_sharding_parallel_group(),
                hcg.get_pipe_parallel_group())

    def global_norm(self, params_grads):
        """The f32 global norm every rank computes alike (a 0-dim tensor),
        None when there is no gradient."""
        parts = {}
        for p, g in params_grads:
            if g is None or getattr(p, "is_firstly_shared", True) is False:
                continue
            key = (_distributed(p),
                   bool(getattr(p, "is_sharding_slice", False)))
            sq = torch.square(torch.linalg.vector_norm(g,
                                                       dtype=torch.float32))
            parts[key] = sq if key not in parts else parts[key] + sq
        if not parts:
            return None
        mp, sh, pp = self._groups()
        if get_world_size() <= 1 or (mp is None and sh is None):
            return torch.sqrt(sum(parts.values()))
        # every rank takes part in every reduction, whatever it holds
        zero = torch.zeros(1, dtype=torch.float32,
                           device=next(iter(parts.values())).device)
        total = zero.clone()
        for key in ((False, False), (True, False), (False, True),
                    (True, True)):
            sq = parts[key].reshape(1).clone() if key in parts \
                else zero.clone()
            if key[0] and mp is not None:
                all_reduce(sq, group=mp)
            if key[1] and sh is not None:
                all_reduce(sq, group=sh)
            total = total + sq
        if pp is not None:
            all_reduce(total, group=pp)
        return torch.sqrt(total[0])

    def __call__(self, params_grads):
        norm = self.global_norm(params_grads)
        if norm is None:
            return params_grads
        scale = _scale_for(norm, self.clip_norm)
        for _, g in params_grads:
            if g is not None:
                g.mul_(scale)
        return params_grads


class HybridParallelGradScaler:
    """Wraps ``amp.GradScaler``: ``found_inf`` is reduced (max) over the
    world between the unscale and the step, so every rank skips alike."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def scale(self, loss):
        return self._scaler.scale(loss)

    def _sync_found_inf(self, device):
        if get_world_size() <= 1:
            return
        t = torch.tensor([float(bool(self._scaler._found_inf))],
                         device=device)
        all_reduce(t, op=ReduceOp.MAX)
        self._scaler._found_inf = bool(t.item() > 0)

    @staticmethod
    def _device(optimizer):
        for p in _innermost(optimizer)._parameter_list():
            return p.device
        return torch.device("cpu")

    def unscale_(self, optimizer):
        out = self._scaler.unscale_(optimizer)
        self._sync_found_inf(self._device(optimizer))
        return out

    def step(self, optimizer):
        # the inner step's own unscale is then a no-op: it steps (or
        # skips) on the agreed found_inf
        self.unscale_(optimizer)
        return self._scaler.step(optimizer)

    def update(self):
        return self._scaler.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        return self.step(optimizer)

    def __getattr__(self, item):
        return getattr(self.__dict__["_scaler"], item)


class GradientMergeOptimizer:
    """Gradient accumulation (the reference's wrapper, which the caller
    builds: ``distributed_optimizer`` does not read
    ``strategy.gradient_merge``): the inner
    optimizer is held back for ``k_steps`` micro-steps while the
    gradients accumulate (``clear_grad`` in the window does nothing), then
    steps once on their sum, divided by ``k_steps`` when ``avg``."""

    def __init__(self, optimizer, k_steps: int = 1, avg: bool = True):
        self._inner_opt = optimizer
        self._k_steps = max(1, int(k_steps))
        self._avg = bool(avg)
        self._micro_step = 0

    @property
    def steps_accumulated(self) -> int:
        return self._micro_step

    @torch.no_grad()
    def step(self):
        self._micro_step += 1
        if self._micro_step < self._k_steps:
            return
        if self._avg and self._k_steps > 1:
            for p in _innermost(self._inner_opt)._parameter_list():
                if p.grad is not None:
                    p.grad.mul_(1.0 / self._k_steps)
        self._inner_opt.step()
        self._inner_opt.clear_grad()
        self._micro_step = 0

    def clear_grad(self, set_to_zero=False):
        if self._micro_step == 0:
            self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)


class LocalSGDOptimizer:
    """Local SGD (``strategy.localsgd``): each rank steps on its own
    gradients and every ``k_steps`` steps the parameters are averaged over
    ``group`` (None: the world). Use it with a model whose gradients are
    not averaged (``DataParallel`` under ``no_sync``, or a bare model)."""

    def __init__(self, optimizer, k_steps: int = 1, group=None):
        self._inner_opt = optimizer
        self._k_steps = max(1, int(k_steps))
        self._group = group
        self._step_count = 0

    def step(self):
        self._inner_opt.step()
        self._step_count += 1
        if self._step_count % self._k_steps == 0:
            self._sync_params()

    @torch.no_grad()
    def _sync_params(self):
        if get_world_size() <= 1:
            return
        for p in _innermost(self._inner_opt)._parameter_list():
            all_reduce(p.data, op=ReduceOp.AVG, group=self._group)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)


class DGCMomentumOptimizer:
    """Deep Gradient Compression (Lin et al.; the reference's
    ``DGCMomentumOptimizer``): per parameter the momentum correction
    ``u = m * u + g`` and the residual ``v += u``; only the largest
    ``1 - sparsity`` of ``|v|`` are applied (a tie at the threshold goes
    with them), the rest stay as residual, and the applied positions are
    cleared in both ``u`` and ``v``. Before ``rampup_begin_step`` it is
    plain momentum SGD on ``u``; then sparsity walks the ``sparsity``
    ladder every ``rampup_step`` steps. With ``sync`` the masked gradients
    are averaged over ``group`` (dense, as the reference's)."""

    def __init__(self, optimizer, momentum=0.9, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), sync=True, group=None):
        self._inner_opt = optimizer
        self._momentum = float(momentum)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(float(s) for s in sparsity)
        self._sync = bool(sync)
        self._group = group
        self._u = {}
        self._v = {}
        self._steps = 0

    def current_sparsity(self) -> float:
        if self._steps < self._rampup_begin:
            return 0.0
        phase = (self._steps - self._rampup_begin) // self._rampup_step
        return self._sparsity[min(phase, len(self._sparsity) - 1)]

    @torch.no_grad()
    def step(self):
        sparsity = self.current_sparsity()
        params = [p for p in _innermost(self._inner_opt)._parameter_list()
                  if p.grad is not None]
        for p in params:
            g = p.grad.float()
            pid = id(p)
            u = self._u.get(pid)
            u = g.clone() if u is None else self._momentum * u + g
            if sparsity <= 0.0 or g.numel() <= 1:
                self._u[pid] = u
                p.grad = u.to(p.grad.dtype, copy=True)
                continue
            v = self._v.get(pid)
            v = u.clone() if v is None else v + u
            k = max(1, int(round(v.numel() * (1.0 - sparsity))))
            thr = torch.topk(v.abs().reshape(-1), k).values[-1]
            mask = v.abs() >= thr
            send = torch.where(mask, v, torch.zeros_like(v))
            self._v[pid] = torch.where(mask, torch.zeros_like(v), v)
            self._u[pid] = torch.where(mask, torch.zeros_like(u), u)
            p.grad = send.to(p.grad.dtype)
        if self._sync and get_world_size() > 1:
            for p in params:
                all_reduce(p.grad, op=ReduceOp.AVG, group=self._group)
        self._steps += 1
        self._inner_opt.step()
        self._inner_opt.clear_grad()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)
