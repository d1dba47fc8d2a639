"""Context parallelism: ring attention and Ulysses all-to-all attention over
the ``sep`` axis of the hybrid mesh (after
``paddle_tpu/distributed/fleet/meta_parallel/context_parallel.py``).

The reference is single-controller SPMD: global ``[B, S, H, D]`` arrays go
into ``shard_map``. The port runs one process per rank, and each rank
passes its LOCAL shard, as PaddleNLP's ``ring_flash_attention`` does:

* ``q``, ``k``, ``v`` are the rank's ``[B, S/W, H, D]`` slices of the
  sequence, where W is the size of the ``sep`` group and the rank's index
  in it is r; the result is the rank's ``[B, S/W, H, D]`` output slice.
* ``q_positions`` / ``kv_positions`` are the rank's slices of the global
  position arrays (the global token index of each local row). They default
  to ``r * S/W + arange(S/W)``, the slices of the reference's global
  ``arange``; a zig-zag layout passes ``zigzag_indices(S, W)`` cut into W
  slices, rank r taking slice r.

:func:`ring_attention` keeps Q in place and rotates K and V one hop a step
around the group (send to rank r+1, receive from r-1, one batched P2P
operation a hop); each step attends the local Q to the visiting K/V chunk
and merges the partial results in log space. The mask comes from the
positions, so a zig-zag layout is only a layout. Its backward is autograd's:
each hop's gradient goes back the other way (the transpose of the ring),
and the chunk attention's gradients come from the flash backward kernel
with the lse cotangent. :func:`ulysses_attention` swaps the sharded dim
from sequence to heads with an all-to-all, runs exact attention over the
whole sequence, and swaps back.

A group of one rank runs one chunk and no communication. A CUDA tensor
needs an NCCL group and a CPU tensor a gloo one; anything else raises.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ....ops.cuda.flash_attention import flash_attention_with_lse
from ... import collective
from ...parallel import get_mesh
from ...topology import Group

__all__ = [
    "ring_attention",
    "ring_attention_op",
    "ulysses_attention",
    "zigzag_indices",
    "RingAttention",
]


def _sep_group(mesh, axis_name, *tensors) -> Group:
    """The group of the mesh dim ``axis_name`` that holds this rank, after
    checking that its backend serves the tensors' device."""
    mesh = mesh if mesh is not None else get_mesh()
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis_name!r}")
    pg = mesh.get_group(axis_name)
    backend = dist.get_backend(pg)
    want = "cpu" if backend == "gloo" else "cuda"
    for t in tensors:
        if t.device.type != want:
            raise ValueError(f"a {t.device.type} tensor on a {backend} group "
                             f"(axis {axis_name!r}): {backend} serves "
                             f"{want} tensors")
    return Group(dist.get_process_group_ranks(pg), axis_name=axis_name,
                 rank=dist.get_rank(pg), process_group=pg)


def _hop(x, group: Group, step):
    """``x`` sent ``step`` ranks on around the group; returns what arrived
    from ``step`` ranks back."""
    n, r = group.nranks, group.rank
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    return collective.p2p_exchange(x, group.ranks[(r + step) % n], out,
                                   group.ranks[(r - step) % n], group)


class _RingShift(torch.autograd.Function):
    """One hop of the ring: send ``x`` to the next rank, return what the
    previous rank sent. Its backward sends the gradient the other way, to
    the previous rank, and returns what the next rank sent back. Every
    rank runs the same hops in the same order, forward and backward, and
    each hop is one matched send/receive pair, so the ring cannot
    deadlock."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad.contiguous(), ctx.group, -1), None


def _ring_drive(kv, kv_pos, group, attend, merge):
    """Attend to the local K/V chunk, then ``world - 1`` times rotate K/V
    one hop, attend and merge. ``kv`` is K and V stacked ``[2, B, S/W, H,
    D]`` (one message a hop); ``kv_pos`` holds every rank's kv positions,
    so the chunk that arrives at step t (rank r - t's) finds its own."""
    rank, world = group.rank, group.nranks
    acc = attend(kv, kv_pos[rank])
    for t in range(1, world):
        kv = _RingShift.apply(kv, group)
        acc = merge(acc, attend(kv, kv_pos[(rank - t) % world]))
    return acc


def _block_attend(q, k, v, scale, mask):
    """One Q chunk against one K/V chunk with materialized f32 logits;
    returns the running statistics ``(m, l, o)``: max and sum of the
    exponentials ``[B, H, Sq]``, unnormalized output ``[B, H, Sq, D]``.
    ``mask`` [Sq, Sk] (True = attend) or None. A fully masked row has m =
    -inf, l = 0, o = 0. The max only keeps the exponentials finite and the
    result does not depend on it, so it carries no gradient."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1).detach()
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bhqd", p, v)


def _online_merge(m, l, o, m_new, l_new, o_new):
    """Merge two partial softmax results (the FlashAttention recurrence),
    keeping -inf maxima (fully masked rows) exp-safe."""
    m_next = torch.maximum(m, m_new)
    m_ref = torch.where(torch.isfinite(m_next), m_next,
                        torch.zeros_like(m_next))
    zero = torch.zeros_like(m)
    a = torch.where(torch.isfinite(m), torch.exp(m - m_ref), zero)
    b = torch.where(torch.isfinite(m_new), torch.exp(m_new - m_ref), zero)
    return (m_next, a * l + b * l_new,
            a[..., None] * o + b[..., None] * o_new)


def _lse_merge(o, lse, o_new, lse_new):
    """Merge two normalized partial results ``o [B, S, H, D]`` (f32) by
    their log-sum-exps ``[B, H, S]``. A chunk that saw no key carries lse
    -1e30 and o 0, which this weighs as nothing (when both do, o stays
    0)."""
    lse_next = torch.logaddexp(lse, lse_new)
    aw = torch.exp(lse - lse_next).transpose(1, 2)[..., None]
    bw = torch.exp(lse_new - lse_next).transpose(1, 2)[..., None]
    return aw * o + bw * o_new, lse_next


def ring_attention(q, k, v, *, mesh=None, axis_name: str = "sep",
                   causal: bool = False, scale: Optional[float] = None,
                   q_positions=None, kv_positions=None, impl: str = "flash"):
    """Ring attention over the mesh dim ``axis_name`` on this rank's shards
    (see the module docstring for the layout).

    ``impl="flash"``: each chunk through the flash kernels
    (``flash_attention_with_lse``, position-masked when causal), merged by
    lse in f32. ``impl="xla"``: the plain version with materialized f32
    logits and the online-softmax merge. Returns the local output shard in
    q's dtype."""
    if impl not in ("flash", "xla"):
        raise ValueError(f"impl must be 'flash' or 'xla', got {impl!r}")
    group = _sep_group(mesh, axis_name, q, k, v)
    rank = group.rank
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    sk = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    dev = q.device
    if q_positions is None:
        q_positions = rank * s + torch.arange(s, device=dev)
    if kv_positions is None:
        kv_positions = rank * sk + torch.arange(sk, device=dev)
    qp = torch.as_tensor(q_positions).to(device=dev, dtype=torch.int32)
    kvp = torch.as_tensor(kv_positions).to(device=dev, dtype=torch.int32)
    if tuple(qp.shape) != (s,) or tuple(kvp.shape) != (sk,):
        raise ValueError(f"positions {tuple(qp.shape)}/{tuple(kvp.shape)} "
                         f"do not match the local lengths ({s},)/({sk},)")
    kv_pos = collective.all_gather([], kvp, group)
    kv = torch.stack([k, v])
    in_dtype = q.dtype

    if impl == "flash":
        def attend(kv_c, kvp_c):
            if causal:
                out, lse = flash_attention_with_lse(
                    q, kv_c[0], kv_c[1], scale=scale, q_positions=qp,
                    kv_positions=kvp_c)
            else:
                out, lse = flash_attention_with_lse(q, kv_c[0], kv_c[1],
                                                    causal=False, scale=scale)
            return out.float(), lse

        o, _ = _ring_drive(kv, kv_pos, group, attend,
                           lambda acc, part: _lse_merge(*acc, *part))
        return o.to(in_dtype)

    qf = q.float()

    def attend_plain(kv_c, kvp_c):
        mask = qp[:, None] >= kvp_c[None, :] if causal else None
        return _block_attend(qf, kv_c[0].float(), kv_c[1].float(), scale,
                             mask)

    m, l, o = _ring_drive(kv, kv_pos, group, attend_plain,
                          lambda acc, part: _online_merge(*acc, *part))
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(in_dtype).transpose(1, 2)


def zigzag_indices(seq_len: int, world: int) -> np.ndarray:
    """Zig-zag chunk assignment for causal load balance: split the sequence
    into ``2·world`` chunks; rank i gets chunks ``(i, 2·world−1−i)`` so every
    rank sees the same causal-mask work (the PaddleNLP/Megatron-CP layout).

    Returns ``perm`` with ``reordered = x[:, perm]``; rank i's slice of it,
    ``perm[i * seq_len // world:(i + 1) * seq_len // world]``, is that
    rank's position array for :func:`ring_attention`. Invert with
    ``argsort(perm)``.
    """
    if seq_len % (2 * world):
        raise ValueError(f"seq {seq_len} must divide by 2*world={2*world}")
    chunk = seq_len // (2 * world)
    order = []
    for r in range(world):
        order.extend(range(r * chunk, (r + 1) * chunk))
        hi = 2 * world - 1 - r
        order.extend(range(hi * chunk, (hi + 1) * chunk))
    return np.asarray(order, dtype=np.int32)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (one equal slice per rank); its
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x, group: Group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.process_group)
    return out


def _seq_to_heads(x, group: Group):
    """Local ``[B, S/W, H, D]`` → ``[B, S, H/W, D]``: head group j goes to
    rank j, and the sequence chunks arrive in rank order."""
    b, sl, h, d = x.shape
    world = group.nranks
    x = x.reshape(b, sl, world, h // world, d).permute(2, 0, 1, 3, 4)
    x = _AllToAll.apply(x, group)         # [W (seq chunk), B, S/W, H/W, D]
    return x.permute(1, 0, 2, 3, 4).reshape(b, world * sl, h // world, d)


def _heads_to_seq(x, group: Group):
    """The inverse of :func:`_seq_to_heads`."""
    b, s, hl, d = x.shape
    world = group.nranks
    sl = s // world
    x = x.reshape(b, world, sl, hl, d).permute(1, 0, 2, 3, 4)
    x = _AllToAll.apply(x, group)         # [W (head group), B, S/W, H/W, D]
    return x.permute(1, 2, 0, 3, 4).reshape(b, sl, world * hl, d)


def _default_attn(q, k, v, causal, scale):
    """Plain softmax attention on ``[B, S, H, D]`` (bottom-right causal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=s.device)
        s = s.masked_fill(~torch.tril(keep, sk - sq), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ulysses_attention(q, k, v, *, mesh=None, axis_name: str = "sep",
                      causal: bool = False, scale: Optional[float] = None,
                      attn_fn=None):
    """DeepSpeed-Ulysses attention on this rank's ``[B, S/W, H, D]``
    shards: all-to-all swaps the sharded dim from sequence to heads, exact
    attention runs over the whole sequence, and a second all-to-all swaps
    back. ``H`` must divide by the ``sep`` degree. ``attn_fn(q, k, v,
    causal, scale)`` defaults to plain softmax attention."""
    group = _sep_group(mesh, axis_name, q, k, v)
    world = group.nranks
    h, d = q.shape[2], q.shape[3]
    if h % world:
        raise ValueError(f"heads {h} not divisible by {axis_name}={world}")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    attn = attn_fn or _default_attn
    if world == 1:
        return attn(q, k, v, causal, scale)
    q, k, v = (_seq_to_heads(t, group) for t in (q, k, v))
    return _heads_to_seq(attn(q, k, v, causal, scale), group)


# torch's autograd records the ring as it runs, so the tensor-level op is
# the function itself
ring_attention_op = ring_attention


class RingAttention:
    """Thin layer-style wrapper for :func:`ring_attention` (keeps the
    incubate fused-layer calling convention)."""

    def __init__(self, axis_name: str = "sep", causal: bool = True):
        self.axis_name = axis_name
        self.causal = causal

    def __call__(self, q, k, v, **kw):
        return ring_attention_op(q, k, v, axis_name=self.axis_name,
                                 causal=self.causal, **kw)
