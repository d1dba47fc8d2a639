"""The pipeline-parallel engine (after
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_engine.py``):
``PipelineParallel.train_batch`` / ``eval_batch`` over the 1F1B, GPipe and
interleaved 1F1B schedules, and ``pipeline_schedule_stats``.

The reference is one SPMD program: a ``lax.scan`` schedule under
``shard_map`` with ``ppermute`` between stages. The port runs one process
a rank, as upstream Paddle does: each rank holds its stage's layers
(``pp_layers.PipelineLayer``), runs its schedule eagerly one microbatch at
a time, and sends activations and their gradients to the neighbouring
stages point to point (``pp_utils.P2PChannel``). The answers are the
reference's: the same losses and, after each step, the same parameters.

Schedules (``strategy.pipeline_configs``):

* ``"1F1B"`` (default): ``pp - stage - 1`` warm-up forwards, then one
  forward and one backward in turn, then the remaining backwards. With
  ``recompute=True`` (the default, as the reference's) a stage keeps only
  each microbatch's input and reruns its forward inside the backward
  (``torch.utils.checkpoint``, which also replays the random state); with
  ``recompute=False`` it keeps the autograd graphs.
* ``"gpipe"``: every forward, then every backward.
* the interleaved 1F1B when the ``PipelineLayer`` has
  ``num_virtual_pipeline_stages > 1``: each device runs the op order of
  ``interleave_schedule._device_op_order`` (upstream's
  ``PipelineParallelWithInterleave``), chunks recomputed as under 1F1B.

The batch: ``train_batch`` takes the global batch on every rank, as the
reference does. Each rank takes its contiguous share over the ``dp`` and
``sharding`` axes and splits it into ``accumulate_steps`` microbatches
(more when ``micro_batch_size`` asks for more). Each microbatch's loss is
the mean of ``loss_fn`` over its rows, seeded into the backward at ``1 /
M`` (times the scaler's scale), so a step's gradient is that of the mean
over the microbatches. The last stage broadcasts the batch's mean loss over
the ``pp`` group and it is averaged over ``dp`` and ``sharding``, so every
rank returns the global batch's mean loss.

The step goes through the optimizer the caller passes (``fleet``'s
``HybridParallelOptimizer``: the ``dp`` average and the hybrid clip), then
``clear_grad``, then ``lr_scheduler.step()``. Weight decay follows the
reference's pipeline rule (a parameter of more than one dim that is not a
bias decays), which the engine sets on the optimizer it is given. A
tied weight held on several stages (``SharedLayerDesc``) starts equal by
a broadcast from its first stage at wrap; its gradients are summed over
those stages before the step, and the hybrid clip counts it once (its
copies carry ``is_firstly_shared = False``). With a scaler, the loss seed
carries its scale, ``found_inf`` is taken over the world (so over the
``pp`` group) and an overflow skips the step on every rank.

``pipeline_schedule_stats`` gives the reference's closed-form numbers for
its compiled lockstep schedules, the same numbers for the same arguments.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from ...collective import ReduceOp, all_reduce, broadcast
from .meta_parallel_base import MetaParallelBase
from .pp_layers import PipelineLayer
from .pp_utils import LocalChannel, P2PChannel

__all__ = ["PipelineParallel", "pipeline_schedule_stats"]


def _unwrap_opt(optimizer):
    """The optimizer under the wrappers (``HybridParallelOptimizer``'s
    ``_inner_opt``, a sharded optimizer's ``_inner``): the one whose rule
    updates the parameters."""
    seen = set()
    opt = optimizer
    while True:
        inner = (opt.__dict__.get("_inner_opt")
                 or opt.__dict__.get("_inner"))
        if inner is None or id(inner) in seen:
            return opt
        seen.add(id(opt))
        opt = inner


def _pipeline_decay(name, p) -> bool:
    """The reference pipeline's weight-decay rule."""
    return not getattr(p, "is_bias", False) and p.dim() > 1


def pipeline_schedule_stats(pp, M, vpp=1, schedule="1f1b",
                            recompute=True):
    """The reference's closed-form compute and bubble figures of its
    compiled lockstep schedules (``ticks``, ``bubble_frac``,
    ``fwd_units``, ``remat_extra_fwd_units``, ``relative_flops``; a unit
    is one microbatch through one device's layers, forward), the same
    numbers for the same arguments."""
    schedule = schedule.lower()
    if vpp > 1:
        from .interleave_schedule import build_interleaved_schedule

        tab = build_interleaved_schedule(pp, vpp, M)
        ticks = int(tab["T"])
        busy = int(tab["f_valid"].sum() + tab["b_valid"].sum())
        slots = ticks * pp * 2
        ideal = 3 * vpp * M
        return {
            "ticks": ticks,
            "bubble_frac": 1.0 - busy / slots,
            "fwd_units": vpp * M,
            "remat_extra_fwd_units": vpp * M,
            "relative_flops": (ideal + vpp * M) / ideal,
        }
    if schedule == "1f1b" and recompute:
        ticks = M + 2 * pp - 2
        return {
            "ticks": ticks,
            "bubble_frac": 1.0 - (2 * M) / (ticks * 2),
            "fwd_units": M,
            "remat_extra_fwd_units": M,
            "relative_flops": (3 * M + M) / (3 * M),
        }
    ticks = M + pp - 1
    return {
        "ticks": 2 * ticks,
        "bubble_frac": 1.0 - M / ticks,
        "fwd_units": M,
        "remat_extra_fwd_units": 0,
        "relative_flops": 1.0,
    }


def _one_f_one_b(pp, M, s):
    warm = min(pp - s - 1, M)
    ops = [("F", 0, f) for f in range(warm)]
    for i in range(M - warm):
        ops += [("F", 0, warm + i), ("B", 0, i)]
    ops += [("B", 0, f) for f in range(M - warm, M)]
    return ops


class PipelineParallel(MetaParallelBase):
    """``fleet.distributed_model`` of a :class:`PipelineLayer` at pp > 1
    (see the module doc)."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        pcfg = dict(getattr(strategy, "pipeline_configs", None) or {})
        self._accumulate_steps = int(pcfg.get("accumulate_steps", 1))
        self._micro_batch_size = pcfg.get("micro_batch_size", None)
        self._schedule = str(pcfg.get("schedule", "1F1B")).lower()
        if self._schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"pipeline_configs.schedule must be '1F1B' or 'gpipe', got "
                f"{self._schedule!r}")
        # strategy.recompute: the GPipe / stash forwards run each chunk
        # under activation checkpointing (the reference's jax.checkpoint
        # of a stage); recompute_interval acts inside the chunk
        self._recompute = bool(getattr(strategy, "recompute", False))
        self._pipeline_recompute = bool(pcfg.get("recompute", True))
        self._pp = (hcg.get_pipe_parallel_world_size() if hcg is not None
                    else layers.get_num_stages())
        self._vpp = layers.get_num_virtual_stages()
        if self._vpp > 1 and self._schedule != "1f1b":
            raise ValueError(
                "num_virtual_pipeline_stages > 1 (interleave) requires "
                "pipeline_configs.schedule='1F1B'")
        if self._pp != layers.get_num_stages():
            raise ValueError(
                f"PipelineLayer built for {layers.get_num_stages()} stages "
                f"but topology has pp={self._pp}")
        self._check_layers(layers)
        if self._pp > 1 and layers.stage_id is None:
            raise ValueError("this PipelineLayer holds every stage: build "
                             "it after fleet.init with pp_degree = "
                             "num_stages")
        self._stage = layers.stage_id or 0
        self.device = layers.device
        if self._pp > 1:
            self._pp_group = hcg.get_pipe_parallel_group()
            ranks = self._pp_group.ranks
        else:
            self._pp_group, ranks = None, [0]
        self._channel = (P2PChannel(ranks, self._stage, self.device)
                         if self._pp > 1 else LocalChannel())
        self._shared = self._tie_shared(layers, ranks)
        self._buffer_snapshot = None
        self._decay_set = set()
        self.last_stats: Dict[str, float] = {}

    # ------------------------------------------------------------- checks
    @staticmethod
    def _check_layers(layers):
        freeze = layers._freeze_buffers
        a, b = layers._body_range
        for i in layers.run_function.indices():
            layer = layers.run_function[i]
            if not freeze and any(True for _ in layer.buffers()):
                raise NotImplementedError(
                    f"pipeline layer {i} ({type(layer).__name__}) has "
                    "buffers (BatchNorm-style running stats); pass "
                    "PipelineLayer(freeze_buffers=True) to keep their "
                    "values through training (eval/frozen-stat semantics)")
        for key, (first, uses) in layers.shared_layers().items():
            if any(a <= i < b for i in uses):
                raise NotImplementedError(
                    "SharedLayerDesc occurrences must live in the pre/post "
                    "segments (tied embeddings/head), not in the repeated "
                    "body")

    def _tie_shared(self, layers, ranks):
        """[(parameter, group)] of each tied weight held on more than one
        stage: the copies broadcast from the first stage's rank, the first
        stage's marked ``is_firstly_shared``, the others not."""
        from ...parallel import subgroup

        tied = []
        for key, (first, uses) in layers.shared_layers().items():
            stages = sorted({layers.get_stage_from_index(i) for i in uses})
            if len(stages) < 2 or self._stage not in stages:
                continue
            group = subgroup([ranks[s] for s in stages])
            owner = self._stage == stages[0]
            with torch.no_grad():
                for p in layers.run_function[first].parameters():
                    broadcast(p.data, ranks[stages[0]], group=group)
                    p.is_firstly_shared = owner
                    tied.append((p, group))
        return tied

    # -------------------------------------------------------------- batch
    def _dp_share(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of a global-batch tensor over the
        ``dp`` and ``sharding`` axes."""
        hcg = self._hcg
        if hcg is None:
            return t
        n_sh = hcg.get_sharding_parallel_world_size()
        n = hcg.get_data_parallel_world_size() * n_sh
        if n <= 1:
            return t
        rank = (hcg.get_data_parallel_rank() * n_sh
                + hcg.get_sharding_parallel_rank())
        if t.shape[0] % n:
            raise ValueError(f"global batch {t.shape[0]} not divisible "
                             f"over {n} data-parallel ranks")
        w = t.shape[0] // n
        return t[rank * w:(rank + 1) * w]

    def _as_tensor(self, x):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        return x.to(self.device)

    def _microbatches(self, x, what="global batch"):
        rows = x.shape[0]
        M = self._accumulate_steps
        if self._micro_batch_size:
            M = max(M, rows // int(self._micro_batch_size))
        if rows % M != 0:
            raise ValueError(f"{what} {rows} not divisible into {M} "
                             f"microbatches")
        return M

    def _split(self, t, M):
        share = self._dp_share(t)
        if share.shape[0] % M:
            raise ValueError(f"a rank's share of {share.shape[0]} rows is "
                             f"not divisible into {M} microbatches")
        return list(share.split(share.shape[0] // M))

    # ------------------------------------------------------------ pieces
    @property
    def _last_virtual(self) -> int:
        return self._pp * self._vpp - 1

    def _chunk_fn(self, d, checkpointed):
        layers = self._layers

        def run(x):
            return layers.forward_chunk(x, d)

        if not checkpointed:
            return run
        return lambda x: torch.utils.checkpoint.checkpoint(
            run, x, use_reentrant=False)

    def _loss(self, out, y):
        return self._layers._loss_fn(out, y).float().mean()

    def _ops(self, M):
        s, pp = self._stage, self._pp
        if self._vpp > 1:
            from .interleave_schedule import _device_op_order

            return _device_op_order(pp, self._vpp, M, s)
        if self._schedule == "gpipe":
            return [("F", 0, f) for f in range(M)] + \
                [("B", 0, f) for f in range(M)]
        return _one_f_one_b(pp, M, s)

    def _run_schedule(self, xs, ys, M, seed, batch_key):
        """Run this rank's op list (see the module doc); returns the sum of
        the microbatch losses on the last stage, else None."""
        pp, s, last = self._pp, self._stage, self._last_virtual
        ch = self._channel
        ops = self._ops(M)
        recompute = (self._pipeline_recompute and self._schedule == "1f1b"
                     ) or self._recompute
        saved, got_input, got_grad = {}, {}, {}
        total = None
        for idx, (kind, c, f) in enumerate(ops):
            d = c * pp + s
            nxt = ops[idx + 1] if idx + 1 < len(ops) else None
            if kind == "F":
                if d == 0:
                    x = xs[f]
                else:
                    x = got_input.pop((d, f), None)
                    if x is None:
                        x = ch.recv_forward((batch_key, d - 1))
                    x.requires_grad_(True)
                if d == last:
                    loss = self._loss(self._chunk_fn(d, False)(x), ys[f])
                    total = loss.detach() if total is None \
                        else total + loss.detach()
                    saved[(d, f)] = (x, loss)
                    continue
                out = self._chunk_fn(d, recompute)(x)
                saved[(d, f)] = (x, out)
                if nxt is not None and nxt[0] == "B" and \
                        nxt[1] * pp + s != last:
                    dn = nxt[1] * pp + s
                    got_grad[(dn, nxt[2])] = ch.send_forward_recv_backward(
                        out, (batch_key, d))
                else:
                    ch.send_forward(out, (batch_key, d))
            else:
                x, out = saved.pop((d, f))
                if d == last:
                    torch.autograd.backward(out * seed)
                else:
                    dy = got_grad.pop((d, f), None)
                    if dy is None:
                        dy = ch.recv_backward(out)
                    torch.autograd.backward(out, dy)
                if d == 0:
                    continue
                dx = x.grad if x.grad is not None else torch.zeros_like(x)
                if nxt is not None and nxt[0] == "F" and \
                        nxt[1] * pp + s != 0:
                    dn = nxt[1] * pp + s
                    got_input[(dn, nxt[2])] = ch.send_backward_recv_forward(
                        dx, (batch_key, dn - 1))
                else:
                    ch.send_backward(dx)
        return total

    def _forward_only(self, xs, ys, M, batch_key, compute_loss):
        """Every microbatch forward, no gradients: the losses' sum (or the
        outputs) on the last stage, else None."""
        pp, s, last = self._pp, self._stage, self._last_virtual
        ch = self._channel
        acc = []
        with torch.no_grad():
            for f in range(M):
                for c in range(self._vpp):
                    d = c * pp + s
                    x = xs[f] if d == 0 else ch.recv_forward(
                        (batch_key, d - 1))
                    out = self._layers.forward_chunk(x, d)
                    if d == last:
                        acc.append(self._loss(out, ys[f]) if compute_loss
                                   else out)
                    else:
                        ch.send_forward(out, (batch_key, d))
        if self._stage != last % pp:
            return None
        return torch.stack(acc).sum() if compute_loss \
            else torch.cat(acc, dim=0)

    def _broadcast_from_last(self, t: Optional[torch.Tensor], like):
        """``t`` of the last stage on every stage of the ``pp`` group."""
        if self._pp_group is None:
            return t
        src = self._pp_group.ranks[-1]
        if like is None:  # shape unknown off the last stage
            meta = torch.zeros(8, dtype=torch.int64, device=self.device)
            if t is not None:
                meta[0] = t.dim()
                meta[1:1 + t.dim()] = torch.tensor(t.shape)
            broadcast(meta, src, group=self._pp_group)
            m = meta.tolist()
            like = torch.empty(tuple(m[1:1 + m[0]]), dtype=torch.float32,
                               device=self.device)
        buf = t.detach().float().contiguous() if t is not None \
            else torch.zeros_like(like)
        return broadcast(buf, src, group=self._pp_group)

    def _dp_mean(self, t):
        hcg = self._hcg
        if hcg is None:
            return t
        for g in (hcg.get_data_parallel_group(),
                  hcg.get_sharding_parallel_group()):
            if g.nranks > 1:
                all_reduce(t, op=ReduceOp.AVG, group=g)
        return t

    def _reduce_shared(self):
        for p, group in self._shared:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            all_reduce(p.grad, op=ReduceOp.SUM, group=group)

    def _set_decay(self, optimizer):
        inner = _unwrap_opt(optimizer)
        if id(inner) not in self._decay_set:
            inner._decay_applies = _pipeline_decay
            self._decay_set.add(id(inner))

    def _frozen(self):
        import contextlib

        if not self._layers._freeze_buffers:
            return contextlib.nullcontext()
        if self._buffer_snapshot is None:
            self._buffer_snapshot = {n: b.detach().clone() for n, b in
                                     self._layers.named_buffers()}
        return self._layers.frozen_buffers(self._buffer_snapshot)

    def _batch_key(self, x, M):
        return (tuple(x.shape), str(x.dtype), M)

    # ------------------------------------------------------------- public
    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def invalidate_compiled(self):
        """The port compiles no schedule, so there is no cache to drop:
        this re-reads the layers' buffers into the snapshot that
        ``freeze_buffers=True`` restores after every batch (the reference
        re-captures its frozen buffers here), so buffer values changed
        from outside count from the next batch on."""
        self._buffer_snapshot = None

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step on the global batch ``data = [inputs, labels]`` (see
        the module doc). Returns the global batch's mean loss, a 0-dim f32
        tensor, on every rank."""
        if self._layers._loss_fn is None:
            raise ValueError("pipeline training needs a loss_fn on the "
                             "PipelineLayer")
        x, y = (self._as_tensor(t) for t in data)
        M = self._microbatches(x)
        if self._vpp > 1 and M % self._pp:
            raise ValueError(f"interleaved schedule needs accumulate_steps "
                             f"({M}) divisible by pp ({self._pp})")
        xs, ys = self._split(x, M), self._split(y, M)
        self._set_decay(optimizer)
        scaled = scaler is not None and getattr(scaler, "_enable", False)
        scale = float(scaler._scale) if scaled else 1.0
        ch = self._channel
        ch.reset_stats()
        t0 = time.perf_counter()
        with self._frozen():
            total = self._run_schedule(xs, ys, M, scale / M,
                                       self._batch_key(x, M))
        ch.finish()
        t1 = time.perf_counter()
        last_here = self._stage == self._last_virtual % self._pp
        mean = (total / M) if last_here else None
        loss = self._dp_mean(self._broadcast_from_last(
            mean, torch.zeros((), device=self.device)))
        self._reduce_shared()
        if scaled:
            # the scaler's own state (under fleet's wrapper, if any)
            base = scaler.__dict__.get("_scaler", scaler)
            scaler.unscale_(optimizer)
            flag = torch.tensor([float(bool(base._found_inf))],
                                device=self.device)
            all_reduce(flag, op=ReduceOp.MAX)
            base._found_inf = bool(flag.item() > 0)
            if not base._found_inf:
                optimizer.step()
            base.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.last_stats = dict(schedule_s=t1 - t0,
                               step_s=time.perf_counter() - t1,
                               p2p_s=ch.stats["s"], p2p_calls=ch.stats["calls"],
                               p2p_bytes=ch.stats["bytes"], microbatches=M)
        return loss

    def eval_batch(self, data, compute_loss: bool = True):
        """The pipelined forward of ``data`` (``[inputs, labels]`` or the
        inputs alone), no gradients: the global batch's mean loss, or
        with ``compute_loss=False`` (or no labels) the model's output for
        this rank's share of the batch, on every stage."""
        x, y = (data if isinstance(data, (list, tuple)) and len(data) == 2
                else (data, None))
        x, y = self._as_tensor(x), self._as_tensor(y)
        M = self._accumulate_steps
        if x.shape[0] % M != 0:
            raise ValueError(f"eval batch {x.shape[0]} not divisible into "
                             f"{M} microbatches")
        with_loss = compute_loss and y is not None \
            and self._layers._loss_fn is not None
        xs = self._split(x, M)
        ys = self._split(y, M) if y is not None else [None] * M
        with self._frozen():
            out = self._forward_only(xs, ys, M, self._batch_key(x, M),
                                     with_loss)
        self._channel.finish()
        if with_loss:
            mean = out / M if out is not None else None
            return self._dp_mean(self._broadcast_from_last(
                mean, torch.zeros((), device=self.device)))
        return self._broadcast_from_last(out, None)
