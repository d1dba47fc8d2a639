"""Ragged (grouped) expert compute for MoE, after
``paddle_tpu/incubate/distributed/models/moe/ragged.py``.

The (token, choice) pairs are sorted by expert and each expert's FFN runs
only over its own rows: the two expert GEMMs are kernel #13 through
``ops.cuda.grouped_matmul.ragged_dot`` (forward and dX on the card; dW one
product per expert), the bias rows and the weighted scatter-add plain
torch. Pairs dropped at capacity are computed and their weight zeroed, so
the answer and its gradients equal the dense GShard path's.
``capacity=None`` is dropless routing.

One change from the reference: a pair whose expert is ``-1`` (a second
choice that ``GShardGate``'s random routing dropped) sorts past the last
group with weight 0. The reference sorts those pairs first without
counting them in the group sizes, which shifts every expert's segment and
keeps the dropped pairs' weights; the dense path dispatches nothing for
them, and so does this one.
"""
from __future__ import annotations

from typing import Optional

import torch

from .....ops.cuda.grouped_matmul import ragged_dot

__all__ = ["ragged_routing", "moe_ragged_ffn", "padded_flops_fraction"]


def ragged_routing(gate_idx, gate_val, num_expert: int,
                   capacity: Optional[int]):
    """Sort (token, choice) pairs by expert for grouped compute.

    Pairs are flattened column-major (every choice-0 pair in token order,
    then choice 1, ...), so each expert's arrival rank, and with it the
    capacity-drop rule, is ``gshard_dispatch``'s. Pairs of expert ``-1``
    go last. Returns ``(tok_sorted, e_sorted, w_sorted, group_sizes)``:
    each sorted pair's token, its expert, its combine weight (zero when
    dropped or of expert -1) and the int32 pair count of each expert
    ``[E]``."""
    t, k = gate_idx.shape
    e_flat = gate_idx.t().reshape(-1)
    v_flat = gate_val.t().reshape(-1)
    tok_flat = torch.arange(t, device=gate_idx.device).repeat(k)
    one = (e_flat[:, None] == torch.arange(
        num_expert, device=gate_idx.device)).to(torch.int32)
    group_sizes = one.sum(0, dtype=torch.int32)
    keep = e_flat >= 0
    if capacity is not None:
        rank = (torch.cumsum(one, 0) * one).sum(-1) - 1
        keep = keep & (rank < capacity)
    v_flat = torch.where(keep, v_flat, torch.zeros((), dtype=v_flat.dtype,
                                                   device=v_flat.device))
    key = torch.where(e_flat >= 0, e_flat, num_expert)
    order = torch.argsort(key, stable=True)
    return tok_flat[order], e_flat[order], v_flat[order], group_sizes


def moe_ragged_ffn(xt, gate_idx, gate_val, w1, b1, w2, b2, act,
                   capacity: Optional[int]):
    """Routed two-linear expert FFN through grouped GEMMs.

    ``xt [T, H]``; ``w1 [E, H, F]``, ``b1 [E, F]``, ``w2 [E, F, H]``,
    ``b2 [E, H]`` (stacked expert parameters in paddle's ``[in, out]``
    layout, the grouped product's rhs orientation); ``act`` elementwise;
    ``capacity=None`` is dropless."""
    t, h = xt.shape
    tok_s, e_s, w_s, group_sizes = ragged_routing(
        gate_idx, gate_val, w1.shape[0], capacity)
    # each pair's bias row as a one-hot product: a bias gradient is then
    # one GEMM summed in f32, not a scatter-add in the working dtype; a
    # pair of expert -1 gets a zero row
    sel = (e_s[:, None] == torch.arange(w1.shape[0], device=e_s.device)
           ).to(xt.dtype)
    xs = xt[tok_s]
    hid = ragged_dot(xs, w1, group_sizes) + sel @ b1
    ys = ragged_dot(act(hid), w2, group_sizes) + sel @ b2
    y = torch.zeros((t, h), dtype=ys.dtype, device=ys.device)
    return y.index_add(0, tok_s, ys * w_s[:, None].to(ys.dtype))


def padded_flops_fraction(num_expert: int, capacity: int, tokens: int,
                          top_k: int) -> float:
    """Fraction of the dense GShard path's expert FLOPs that are padding,
    what the ragged path saves: dense runs ``E * C`` rows, ragged the
    ``k * T`` real pairs."""
    dense_rows = num_expert * capacity
    return max(0.0, 1.0 - (top_k * tokens) / dense_rows)
