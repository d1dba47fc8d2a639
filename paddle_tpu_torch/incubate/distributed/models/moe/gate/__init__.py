"""MoE gates, after ``paddle_tpu/incubate/distributed/models/moe/gate/``.

Each gate maps token activations ``[T, d_model]`` to ``(values, indices)``
of its top-k experts. The GShard and Switch gates keep a load-balancing
auxiliary loss, ``E · Σ_e density_e · mean gate prob_e``, that ``get_loss()``
returns (and clears). Everything is differentiable with plain autograd.

The random draws take an explicit ``torch.Generator`` on the gate's device:
the gate's ``generator``, else the next one of
``framework.random.next_generator`` for each forward (the reference draws
from its global key stream). ``GShardGate``'s random routing drops a
token's second choice, writing expert ``-1``, where ``2 · val₂ < r`` for
``r`` uniform in ``[0, 1)`` drawn in f32, one a token; ``SwitchGate``
scales its logits by a uniform jitter in ``[1 - eps, 1 + eps]`` drawn in
f32. Both draw only in training.

At ep > 1 (``MoELayer`` gives the gate its expert group, ``_ep_group``)
the gate is the reference's global one over the group's tokens: the aux
loss's two means are over the global tokens (the sums and the count
all-reduced, the gate probabilities' through the autograd all-reduce, so
the loss and its gradient are the global ones), and each random draw is
made for ``ep`` times this rank's tokens, rank-major, of which the rank
takes its own rows. With one generator state on every rank that is the
draw of the global batch at ep = 1. The draws are held by rule, not by
the reference's bits.
"""
from __future__ import annotations

import torch

from ......distributed.collective import all_reduce, fcollectives
from ......framework import random as _random
from ......nn.common import Linear
from ......nn.layer import Layer

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


class BaseGate(Layer):
    def __init__(self, num_expert: int, world_size: int = 1,
                 generator=None):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.generator = generator
        self._loss = None
        self._ep_group = None

    def set_loss(self, loss):
        self._loss = loss

    def get_loss(self, clear: bool = True):
        loss = self._loss
        if clear:
            self._loss = None
        return loss

    @property
    def has_loss(self) -> bool:
        return self._loss is not None

    def _generator(self, device):
        return self.generator or _random.next_generator(device)

    def _rows(self, draw, t):
        """This rank's ``t`` rows of ``draw(n)``, a draw of ``n`` rows made
        for the group's ``n = ep * t`` rows (``draw(t)`` at one rank)."""
        grp = self._ep_group
        if grp is None:
            return draw(t)
        return draw(grp.nranks * t)[grp.rank * t:(grp.rank + 1) * t]

    def _aux_loss(self, gates, top1):
        """The load-balance loss, over the group's tokens at ep > 1."""
        grp = self._ep_group
        if grp is None:
            return _load_balance_loss(gates, top1)
        e = gates.shape[-1]
        mask = torch.nn.functional.one_hot(top1, e).to(gates.dtype).sum(0)
        count = torch.full((1,), gates.shape[0], dtype=gates.dtype,
                           device=gates.device)
        stats = all_reduce(torch.cat([mask, count]), group=grp)
        probs = fcollectives.all_reduce(gates.sum(0), grp)
        n = stats[-1]
        return torch.sum((stats[:-1] / n) * (probs / n)) * e


class NaiveGate(BaseGate):
    """Linear gate, top-k, combine weights the softmax over the selected
    logits; no auxiliary loss."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(num_expert, world_size, generator)
        self.gate = Linear(d_model, self.tot_expert, device=device,
                           dtype=dtype)
        self.top_k = topk

    def forward(self, inp, return_all_scores: bool = False):
        gate_logits = self.gate(inp)
        top, idx = torch.topk(gate_logits, self.top_k, dim=-1)
        val = torch.softmax(top, dim=-1)
        if return_all_scores:
            return val, idx, gate_logits
        return val, idx


def _load_balance_loss(gates, top1):
    """GShard/Switch aux loss: ``E · Σ_e density_e · density_proxy_e``,
    density the fraction of tokens whose first choice is e, the proxy the
    mean gate probability of e."""
    e = gates.shape[-1]
    mask = torch.nn.functional.one_hot(top1, e).to(gates.dtype)
    return torch.sum(mask.mean(0) * gates.mean(0)) * e


class GShardGate(BaseGate):
    """Top-2 gate with the load-balance aux loss, ``(train, eval)``
    capacity factors and random routing of the second choice."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4),
                 random_routing: bool = True, group=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(num_expert, world_size, generator)
        if topk != 2:
            raise ValueError("GShardGate reference implementation uses "
                             "topk=2")
        self.gate = Linear(d_model, self.tot_expert, device=device,
                           dtype=dtype)
        self.top_k = 2
        self.capacity = capacity
        self.random_routing = random_routing

    def forward(self, inp):
        gates = torch.softmax(self.gate(inp), dim=-1)
        val, idx = torch.topk(gates, 2, dim=-1)
        self.set_loss(self._aux_loss(gates, idx[:, 0]))
        if self.random_routing and self.training:
            gen = self._generator(val.device)
            r = self._rows(lambda n: torch.rand(
                n, generator=gen, device=val.device), idx.shape[0])
            second = torch.where(2.0 * val[:, 1].detach().float() < r,
                                 torch.full_like(idx[:, 1], -1), idx[:, 1])
            idx = torch.stack([idx[:, 0], second], dim=-1)
        return val, idx


class SwitchGate(BaseGate):
    """Top-1 gate (Switch Transformer) with the aux loss and a jitter of
    the logits in training."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1, capacity=(1.2, 2.4),
                 group=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(num_expert, world_size, generator)
        if topk != 1:
            raise ValueError("SwitchGate routes top-1")
        self.gate = Linear(d_model, self.tot_expert, device=device,
                           dtype=dtype)
        self.top_k = 1
        self.switch_eps = switch_eps
        self.capacity = capacity

    def forward(self, inp):
        logits = self.gate(inp)
        if self.training and self.switch_eps > 0:
            gen = self._generator(logits.device)

            def draw(n):
                noise = torch.empty((n, logits.shape[-1]),
                                    device=logits.device,
                                    dtype=torch.float32)
                return noise.uniform_(1.0 - self.switch_eps,
                                      1.0 + self.switch_eps, generator=gen)

            noise = self._rows(draw, logits.shape[0])
            logits = logits * noise.to(logits.dtype)
        gates = torch.softmax(logits, dim=-1)
        val, idx = torch.topk(gates, 1, dim=-1)
        self.set_loss(self._aux_loss(gates, idx[:, 0]))
        return val, idx
