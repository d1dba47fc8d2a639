"""Paged KV caches and their decode and verify attention.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``:

* the functional serving path: ``PagedCacheState``, ``quantize_rows_int8``,
  ``_store_rows``, ``paged_state_prefill``, ``paged_state_step``,
  ``paged_state_verify``, the ``PagedCacheState`` branch of
  ``paged_forward``, ``paged_slab_decode_attention`` (TPU kernel
  ``_paged_slab_kernel``, #1) and ``paged_verify_slab_attention`` (TPU
  kernel ``_paged_verify_slab_kernel``, #3);
* the host-managed cache: ``PagedKVCache``, its branch of
  ``paged_forward`` and ``paged_decode_attention`` (TPU kernel
  ``_paged_kernel``, #4).

Each kernel has its plain twin beside its wrapper. The CUDA sources are
``paddle_tpu_torch/csrc/paged_decode_attention.cu`` (#1),
``paged_decode_attention_v1.cu`` (#4) and ``paged_verify_attention.cu``
(#3).

Page layouts, as in the reference. The functional state keeps slab pages
``[P, page_size, Hkv*D]`` (heads side by side in one slab row); physical
page 0 is the trash page that idle slots and padding write into; int8
pages carry a bf16 scale page ``[P, page_size, 128]`` with k scales at
lanes ``[0, Hkv)`` and v scales at ``[Hkv, 2*Hkv)``. ``PagedKVCache`` keeps
head-major pages ``[Hkv, P, page_size, D]`` and, for int8, f32 scales
``[Hkv, P, page_size]``, one per row.

Unlike the JAX version, page writes happen IN PLACE (``index_put_``) on the
page tensors: a returned state shares them. Lengths are new tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...kernels.build import launch_counter

__all__ = ["PagedCacheState", "PagedKVCache", "quantize_rows_int8",
           "paged_state_prefill", "paged_state_step", "paged_state_verify",
           "paged_forward", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_slab_decode_attention",
           "decode_splits", "decode_chunk", "decode_min_chunk",
           "decode_chunked_ref",
           "paged_slab_decode_attention_ref", "paged_verify_slab_attention",
           "paged_verify_slab_attention_ref", "paged_verify_chunked_ref",
           "verify_body", "verify_splits", "verify_chunk",
           "paged_multi_query_attention"]

NEG_INF = -1.0e30
_HEAD_DIMS = (32, 64, 128, 256)
_VERIFY_HEAD_DIMS = (64, 128, 256)
_VERIFY_TC_HEAD_DIMS = (64, 128)
_VERIFY_TILE = 64           # keys a tile of the verify kernel
_VERIFY_WARPS_PER_SM = 8    # split-K aims the grid at this many warps an SM
_VERIFY_MAX_SPLITS = 16
_DECODE_TILE = 16           # rows a decode chunk is rounded up to
_DECODE_BLOCKS_PER_SM = 8   # decode split-K aims the grid at this many
_DECODE_MAX_SPLITS = 16
# the fewest rows of capacity a decode split is worth: 512 while the grid
# leaves SMs without a block, 1024 once every SM has one (a split then
# pays only against windows much longer than a block walks quickly)
_DECODE_MIN_CAPACITY = (512, 1024)
# the fewest rows a decode chunk holds once every SM has a block: a window
# this short is walked whole, with no partials and no merge
_DECODE_FULL_GRID_CHUNK = 512


class PagedCacheState:
    """One layer's paged cache as the engine threads it through a forward:
    pages, block tables ``[B, max_pages]`` i32 and lengths ``[B]`` i32, all
    tensors on one device. ``lengths[b] == 0`` marks an idle slot: its
    writes go to the trash page and its output is discarded.
    ``prefill_valid`` ([B] i32) marks an admission forward and carries each
    row's valid prompt width. ``verify`` marks a multi-query forward over
    the cache (spec verify, suffix prefill, chunked prefill): see
    :func:`paged_state_verify`. ``ordered_writes`` makes colliding page
    writes land as they would one by one (:func:`_last_writers`)."""

    def __init__(self, k_pages, v_pages, scale_pages, block_tables, lengths,
                 page_size, prefill_valid=None, verify=False,
                 ordered_writes=False):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.scale_pages = scale_pages
        self.block_tables = block_tables
        self.lengths = lengths
        self.page_size = int(page_size)
        self.prefill_valid = prefill_valid
        self.verify = bool(verify)
        self.ordered_writes = bool(ordered_writes)

    @property
    def quantized(self):
        return self.scale_pages is not None

    @property
    def capacity(self) -> int:
        return self.block_tables.shape[1] * self.page_size

    def positions(self, s):
        """Slot b's next ``s`` tokens sit at ``[lengths[b], lengths[b]+s)``,
        clamped at the table capacity minus one (a chain-overshooting
        straggler saturates ``lengths`` at the capacity)."""
        pos = (self.lengths[:, None].long()
               + torch.arange(s, device=self.lengths.device)[None])
        return torch.clamp(pos, max=self.capacity - 1)

    def replace(self, **kw):
        fields = dict(k_pages=self.k_pages, v_pages=self.v_pages,
                      scale_pages=self.scale_pages,
                      block_tables=self.block_tables, lengths=self.lengths,
                      prefill_valid=self.prefill_valid, verify=self.verify,
                      ordered_writes=self.ordered_writes)
        fields.update(kw)
        return PagedCacheState(page_size=self.page_size, **fields)


def quantize_rows_int8(x):
    """Symmetric per-row int8 over the last dim: x [..., D] → (int8 values,
    f32 scales [...])."""
    xf = x.float()
    scales = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    vals = torch.clamp(torch.round(xf / scales[..., None]), -127, 127)
    return vals.to(torch.int8), scales


def _store_rows(state, k, v):
    """k/v [..., Hkv, D] → (k rows, v rows [..., Hkv*D], scale rows
    [..., 128] bf16 or None) in the pages' storage dtype."""
    lead = k.shape[:-2]
    h_kv = k.shape[-2]
    flat = lead + (h_kv * k.shape[-1],)
    if not state.quantized:
        dt = state.k_pages.dtype
        return k.to(dt).reshape(flat), v.to(dt).reshape(flat), None
    kq, ks = quantize_rows_int8(k)
    vq, vs = quantize_rows_int8(v)
    sc = torch.zeros(lead + (128,), dtype=torch.bfloat16, device=k.device)
    sc[..., :h_kv] = ks.to(torch.bfloat16)
    sc[..., h_kv:2 * h_kv] = vs.to(torch.bfloat16)
    return kq.reshape(flat), vq.reshape(flat), sc


def _last_writers(state, phys, slotpos):
    """For each write (row-major over ``phys``), the index of the last write
    to the same (page, slot): the one that lands when the writes go one by
    one, as on the CPU and in the reference. Writes collide on the trash
    page (idle rows, padding, a chain's overshoot past its pages) and where
    a verify block clamps at the capacity, and the card's scatter lands an
    unordered one of them. Discarded rows then read that slot back, which
    is harmless for a dense model but not for an MoE one, whose discarded
    rows compete with the live ones for expert capacity."""
    key = (phys.long() * state.page_size + slotpos.long()).reshape(-1)
    idx = torch.arange(key.numel(), device=key.device)
    last = torch.full((state.k_pages.shape[0] * state.page_size,), -1,
                      dtype=torch.long, device=key.device)
    last.scatter_reduce_(0, key, idx, reduce="amax")
    return last[key]


def _write(state, phys, slotpos, k, v):
    kq, vq, sc = _store_rows(state, k, v)
    if state.ordered_writes:
        # every colliding write carries the last writer's row, so the
        # scatter lands the same bytes whichever of them it keeps
        src = _last_writers(state, phys, slotpos)
        kq, vq, sc = (None if t is None else
                      t.reshape(src.numel(), -1)[src].reshape(t.shape)
                      for t in (kq, vq, sc))
    idx = (phys, slotpos)
    state.k_pages.index_put_(idx, kq)
    state.v_pages.index_put_(idx, vq)
    if state.quantized:
        state.scale_pages.index_put_(idx, sc)


def paged_state_prefill(state, k, v, real_len):
    """Write a (padded) prompt into the pages. k/v [B, S0, Hkv, D];
    positions at or past ``real_len[b]`` go to the trash page. Returns the
    state with ``lengths += real_len``."""
    s0 = k.shape[1]
    pos = state.positions(s0)
    valid = (torch.arange(s0, device=k.device)[None]
             < real_len[:, None].long())
    logical = torch.clamp(pos // state.page_size, 0,
                          state.block_tables.shape[1] - 1)
    bt = state.block_tables.long()
    phys = torch.where(valid, torch.gather(bt, 1, logical),
                       torch.zeros_like(logical))
    slotpos = torch.where(valid, pos % state.page_size,
                          torch.zeros_like(pos))
    _write(state, phys, slotpos, k, v)
    return state.replace(lengths=state.lengths + real_len.to(
        state.lengths.dtype))


def paged_state_step(state, q, k, v, scale=None):
    """Append one token per active slot and attend. q [B, H, D], k/v
    [B, Hkv, D] → (out [B, H, D], state). Idle slots (length 0) write to the
    trash page; their output is zeros and discarded. Lengths cap at the
    table capacity."""
    b = q.shape[0]
    lengths = state.lengths
    active = lengths > 0
    pos = lengths.long()
    logical = torch.clamp(pos // state.page_size, 0,
                          state.block_tables.shape[1] - 1)
    rows = torch.arange(b, device=q.device)
    phys = torch.where(active, state.block_tables.long()[rows, logical],
                       torch.zeros_like(pos))
    slotpos = torch.where(active, pos % state.page_size,
                          torch.zeros_like(pos))
    _write(state, phys, slotpos, k, v)
    state = state.replace(lengths=torch.clamp(
        lengths + active.to(lengths.dtype), max=state.capacity))
    out = paged_slab_decode_attention(
        q, state.k_pages, state.v_pages, state.block_tables, state.lengths,
        q.shape[1], scale=scale, scale_pages=state.scale_pages)
    return out.to(q.dtype), state


def paged_state_verify(state, q, k, v, scale=None):
    """Append ``m`` tokens per row at ``[lengths, lengths + m)`` and score
    every position over the cache plus the causal prefix of the new block.
    q [B, m, H, D], k/v [B, m, Hkv, D] → (out [B, m, H, D] in q's dtype,
    state).

    Spec-verify form (``prefill_valid`` None): rows with ``lengths == 0``
    are idle (writes to the trash page); active rows advance by m, and the
    caller rolls ``lengths`` back to the accepted prefix.

    Partial-prefill form (``prefill_valid`` [B] widths; prefix-cache suffix
    prefill and chunked prefill): row b holds ``lengths[b]`` cached tokens
    and appends ``prefill_valid[b]`` of the m columns; the columns past its
    width write to the trash page and advance nothing. A row with base 0 is
    a prefill from scratch, a row of width 0 is idle.

    The block's K/V are written in place (``index_put_``) on the stream
    before the attention launch reads them. Lengths cap at the capacity."""
    b, m = q.shape[:2]
    base = state.lengths
    dev = q.device
    if state.prefill_valid is not None:
        widths = state.prefill_valid.to(base.dtype)
        valid = (torch.arange(m, device=dev)[None, :] < widths[:, None])
        adv = widths
    else:
        active = base > 0
        valid = active[:, None].expand(b, m)
        adv = m * active.to(base.dtype)
    pos = state.positions(m)  # [B, m], clamped at capacity - 1
    logical = torch.clamp(pos // state.page_size, 0,
                          state.block_tables.shape[1] - 1)
    phys = torch.where(valid,
                       torch.gather(state.block_tables.long(), 1, logical),
                       torch.zeros_like(logical))
    slotpos = torch.where(valid, pos % state.page_size, torch.zeros_like(pos))
    _write(state, phys, slotpos, k, v)
    new_state = state.replace(lengths=torch.clamp(base + adv,
                                                  max=state.capacity))
    out = paged_multi_query_attention(q, new_state, base, scale=scale)
    return out.to(q.dtype), new_state


def paged_forward(cache, q, k, v, context_attention, time_step=None):
    """Model-side paged-cache step for one attention layer. q/k/v
    [b, s, heads, head_dim]. Always returns ``(out, cache)``.

    With a host-managed :class:`PagedKVCache`: prefill (``time_step``
    None) writes the prompt and returns ``context_attention()``'s result;
    decode appends one token per slot and attends over the pages (#4).
    Decode requires ``time_step`` to equal EVERY slot's length: a replayed
    or skipped step would corrupt the cache silently (append is no
    overwrite), and ragged per-slot lengths need ``PagedCacheState``.
    ``time_step`` is a keyword here (the reference takes it before
    ``context_attention``).

    With a ``PagedCacheState`` (the engine) ``time_step`` is ignored. A
    ``verify`` state is a multi-query forward over the cache
    (:func:`paged_state_verify`; checked first, since its block is
    multi-token). With ``prefill_valid`` set (every admission) or a
    multi-token input this is a prefill: the prompt is written and
    ``context_attention()`` gives the output. Otherwise one decode token
    per slot."""
    if isinstance(cache, PagedKVCache):
        if time_step is None:
            cache.prefill(k, v)
            return context_attention(), cache
        ts = int(time_step)
        if not np.all(cache.lengths == ts):
            raise ValueError(
                f"paged decode at time_step={ts} but cache slots hold "
                f"{cache.lengths.tolist()} tokens — paged caches append; "
                "replay/skip requires free()+prefill, and ragged per-slot "
                "lengths need the functional PagedCacheState engine path")
        cache.append(k[:, 0], v[:, 0])
        return cache.attend(q[:, 0])[:, None], cache
    if not isinstance(cache, PagedCacheState):
        raise TypeError("paged_forward takes a PagedKVCache or a "
                        "PagedCacheState")
    if cache.verify:
        return paged_state_verify(cache, q, k, v)
    if cache.prefill_valid is not None or q.shape[1] > 1:
        s0 = k.shape[1]
        real_len = (torch.full((q.shape[0],), s0, dtype=torch.int32,
                               device=q.device)
                    if cache.prefill_valid is None else cache.prefill_valid)
        new_state = paged_state_prefill(cache, k, v, real_len)
        return context_attention(), new_state
    out, new_state = paged_state_step(cache, q[:, 0], k[:, 0], v[:, 0])
    return out[:, None], new_state


def paged_slab_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                    lengths, scale=None, scale_pages=None):
    """Plain twin of the kernel (after the JAX ``_paged_slab_ref`` with
    ``decode_attention_ref`` inlined): gather each row's whole window, f32
    logits masked past ``min(lengths, capacity)``, softmax, P.V. A row of
    length 0 gives zeros (the kernel's guard; the JAX ref gives a
    meaningless window mean there, which the engine discards). Returns
    [B, H, D] in q's dtype."""
    b, h, d = q.shape
    _, page_size, khd = k_pages.shape
    h_kv = khd // d
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    max_pages = bt.shape[1]
    seq = max_pages * page_size

    def window(pages, sc):
        win = pages[bt].float().reshape(b, seq, h_kv, d)
        if sc is not None:
            win = win * sc.float()[..., None]
        return win.transpose(1, 2)  # [B, Hkv, S, D]

    ks = vs = None
    if scale_pages is not None:
        scw = scale_pages[bt].reshape(b, seq, 128)
        ks, vs = scw[..., :h_kv], scw[..., h_kv:2 * h_kv]
    k_c = window(k_pages, ks)
    v_c = window(v_pages, vs)
    group = h // h_kv
    qg = q.reshape(b, h_kv, group, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_c) * scale
    ids = torch.arange(seq, device=q.device)[None, None, None, :]
    s = torch.where(ids < lengths.long()[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_c).reshape(b, h, d)
    out = torch.where((lengths > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, lengths, scale_pages,
           q_rank):
    """Operand checks shared by both wrappers: q [B, H, D] (decode,
    ``q_rank`` 3) or [B, m, H, D] (verify, 4)."""
    if q.dim() != q_rank or k_pages.dim() != 3:
        raise ValueError("q [B, H, D] (decode) or [B, m, H, D] (verify), "
                         "pages [P, page_size, Hkv*D]")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k and v pages must match in shape and dtype")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    khd = k_pages.shape[2]
    if khd % d:
        raise ValueError(f"page lanes ({khd}) must hold whole KV heads of "
                         f"head_dim={d}")
    if h % (khd // d):
        raise ValueError("q heads must be a multiple of kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("block_tables must be [B, max_pages]")
    if lengths.shape != (b,):
        raise ValueError("lengths / base_len must be [B]")
    quantized = scale_pages is not None
    if quantized != (k_pages.dtype == torch.int8):
        raise TypeError("int8 pages need scale_pages, other pages none")
    if quantized and (scale_pages.dtype != torch.bfloat16
                      or tuple(scale_pages.shape)
                      != tuple(k_pages.shape[:2]) + (128,)):
        raise ValueError("scale_pages must be bf16 [P, page_size, 128]")
    tensors = [q, k_pages, v_pages, block_tables, lengths] + (
        [scale_pages] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must live on one device")


def _decode_head_chunk(group) -> int:
    """GC, the q heads of one GQA group a decode block serves: 4, 2 or 1,
    the largest that divides the group (csrc/decode_kernel.cuh)."""
    return 4 if group % 4 == 0 else (2 if group % 2 == 0 else 1)


def _decode_blocks(batch, num_heads, num_kv_heads) -> int:
    """The decode grid's blocks at one chunk a window."""
    group = num_heads // num_kv_heads
    return batch * num_kv_heads * (group // _decode_head_chunk(group))


def decode_chunk(length, splits, min_chunk=_DECODE_TILE) -> int:
    """Rows of a window of ``length`` live rows that one of ``splits``
    decode chunks holds, as each block cuts it on the card:
    ``ceil(length / splits)`` rounded up to whole 16-row tiles and to
    ``min_chunk``. Chunk ``s`` is ``[s * chunk, min(length, (s + 1) *
    chunk))``; a block whose chunk starts at or past the last row has
    nothing to do."""
    per = -(-max(0, length) // max(1, splits))
    return max(-(-per // _DECODE_TILE) * _DECODE_TILE, min_chunk)


def decode_min_chunk(batch, num_heads, num_kv_heads, sm_count) -> int:
    """The fewest rows a decode chunk holds, from host-known values only:
    16 (one tile) while the grid leaves SMs without a block, where every
    chunk fills an idle SM; ``_DECODE_FULL_GRID_CHUNK`` once every SM has
    one, so that only windows long enough to repay the partials and the
    merge are cut."""
    if _decode_blocks(batch, num_heads, num_kv_heads) < sm_count:
        return _DECODE_TILE
    return _DECODE_FULL_GRID_CHUNK


def decode_splits(batch, num_heads, num_kv_heads, capacity,
                  sm_count) -> int:
    """How many chunks the decode kernels (#1, #4, #14, #15) cut each
    sequence's live window into, from host-known values only: the call
    never reads ``lengths`` (a card tensor on the engine's path) and never
    waits for the card. One chunk when the grid (batch x kv heads x head
    chunks) already holds ``_DECODE_BLOCKS_PER_SM`` blocks an SM; else
    enough chunks to reach that, at most ``_DECODE_MAX_SPLITS``, and no
    more than the capacity holds chunks of ``_DECODE_MIN_CAPACITY`` rows
    (the larger minimum once the grid gives every SM a block): a split
    costs each block a partial write and the merge, which short chunks do
    not repay (measured in PERF.md). The count is that of the chunks
    ``decode_chunk`` makes of a window at the capacity, so at the capacity
    no chunk lies wholly past the window."""
    blocks = _decode_blocks(batch, num_heads, num_kv_heads)
    want = _DECODE_BLOCKS_PER_SM * sm_count
    if blocks >= want:
        return 1
    fewest = _DECODE_MIN_CAPACITY[blocks >= sm_count]
    splits = min(-(-want // blocks), capacity // fewest, _DECODE_MAX_SPLITS)
    if splits <= 1:
        return 1
    return -(-capacity // decode_chunk(capacity, splits))


def decode_chunked_ref(q, k, v, lengths, splits, scale=None,
                       min_chunk=_DECODE_TILE):
    """Plain twin of the decode kernels' split arithmetic: each row's live
    window (``min(lengths[b], S)`` rows of k/v ``[B, Hkv, S, D]``, already
    gathered and dequantized) cut into the chunks of ``decode_chunk`` (at
    least ``min_chunk`` rows), each chunk's softmax over its own rows (o
    normalised over them, and their log-sum-exp, -inf where the chunk
    holds no row), then the chunks weighed in log space in split order. A
    row of length 0 gives zeros. Returns ``[B, H, D]`` in q's dtype."""
    b, h, d = q.shape
    h_kv, s_max = k.shape[1], k.shape[2]
    group = h // h_kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, h_kv, group, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    vf = v.float()
    out = torch.zeros((b, h_kv, group, d), dtype=torch.float32,
                      device=q.device)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s_max)
        if n == 0:
            continue
        chunk = decode_chunk(n, splits, min_chunk)
        outs, lses = [], []
        for sp in range(splits):
            lo = min(n, sp * chunk)
            hi = min(n, lo + chunk)
            if hi == lo:
                outs.append(torch.zeros_like(out[bi]))
                lses.append(torch.full((h_kv, group, 1), -math.inf,
                                       device=q.device))
                continue
            sc = scores[bi, :, :, lo:hi]
            mx = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - mx)
            l_c = p.sum(-1, keepdim=True)
            outs.append(torch.einsum("kgs,ksd->kgd", p, vf[bi, :, lo:hi])
                        / l_c)
            lses.append(mx + torch.log(l_c))
        lse = torch.stack(lses)                        # [C, Hkv, g, 1]
        top = lse.amax(0)
        w = torch.where(lse == -math.inf, torch.zeros_like(lse),
                        torch.exp(lse - top))
        out[bi] = (w * torch.stack(outs)).sum(0) / w.sum(0)
    return out.reshape(b, h, d).to(q.dtype)


def _decode_split_args(device, batch, num_heads, head_dim, splits):
    """The scratch of a split decode launch: (part_o [splits, B, H, D],
    part_lse [splits, B, H], the arrival counters), or three Nones for one
    split. The tensors must stay referenced until the launch is queued."""
    if splits <= 1:
        return None, None, None
    from ...kernels import build

    part_o = torch.empty((splits, batch, num_heads, head_dim),
                         dtype=torch.float32, device=device)
    part_lse = torch.empty((splits, batch, num_heads), dtype=torch.float32,
                           device=device)
    return part_o, part_lse, build.arrival_counters(device,
                                                    batch * num_heads)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def paged_slab_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                num_heads=None, scale=None,
                                scale_pages: Optional[torch.Tensor] = None):
    """Slab-paged decode attention: q [B, H, D]; pages [P, page_size,
    Hkv*D]; block_tables [B, max_pages] i32; lengths [B] i32 (the new token
    already written). ``scale_pages`` selects the int8 path. Returns
    [B, H, D] in q's dtype. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel (``.launches`` counts them) or raises. Each
    window is cut into ``decode_splits`` chunks on the card and merged in
    the same launch."""
    return _paged_slab_decode(q, k_pages, v_pages, block_tables, lengths,
                              num_heads, scale, scale_pages)


def _paged_slab_decode(q, k_pages, v_pages, block_tables, lengths,
                       num_heads=None, scale=None, scale_pages=None,
                       splits=None):
    """``paged_slab_decode_attention`` with its chunk count chosen by the
    caller instead of by ``decode_splits``: how the card tests force the
    split and how ``chip_smoke.py`` times the unsplit body (``splits=1``)
    beside the split one."""
    _check(q, k_pages, v_pages, block_tables, lengths, scale_pages, 3)
    if num_heads is not None and num_heads != q.shape[1]:
        raise ValueError("num_heads disagrees with q")
    if q.device.type == "cpu":
        return paged_slab_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, scale, scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from ...kernels import build

    b, h, d = q.shape
    _, page_size, khd = k_pages.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes f32 or bf16 q, got {q.dtype}")
    if k_pages.dtype not in (q.dtype, torch.int8):
        raise TypeError("pages must be q's dtype or int8")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {_HEAD_DIMS}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    tensors = [q, k_pages, v_pages, block_tables, lengths] + (
        [scale_pages] if scale_pages is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode kernel operands must be contiguous")
    if h > 65535:
        raise ValueError("too many heads for the kernel grid")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    h_kv = khd // d
    if splits is None:
        splits = decode_splits(b, h, h_kv, block_tables.shape[1] * page_size,
                               _sm_count(q.device))
    part_o, part_lse, counters = _decode_split_args(q.device, b, h, d,
                                                    splits)
    min_chunk = decode_min_chunk(b, h, h_kv, _sm_count(q.device))
    out = torch.empty_like(q)
    lib = build.load("paged_decode_attention")
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _ptr(scale_pages), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, h_kv, d, page_size, block_tables.shape[1],
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        float(scale), int(splits), min_chunk, _ptr(part_o), _ptr(part_lse),
        _ptr(counters), build.stream_ptr(q.device))
    build.check(rc, "paged_decode_attention")
    paged_slab_decode_attention.launches += 1
    return out


launch_counter(paged_slab_decode_attention, "launches")


def paged_verify_slab_attention_ref(q, k_pages, v_pages, block_tables,
                                    base_len, scale=None, scale_pages=None):
    """Plain twin of the verify kernel (the JAX ``_paged_multi_query_ref``):
    gather each row's whole window, f32 logits, query j of row b masked to
    tokens ``< min(base_len[b] + j + 1, capacity)``, softmax normalised
    before P.V, GQA by sharing each KV head over its group. Returns
    ``[B, m, H, D]`` f32."""
    b, m, h, d = q.shape
    _, page_size, khd = k_pages.shape
    h_kv = khd // d
    group = h // h_kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    seq = bt.shape[1] * page_size

    def window(pages, sc):
        win = pages[bt].float().reshape(b, seq, h_kv, d)
        if sc is not None:
            win = win * sc.float()[..., None]
        return win  # [B, S, Hkv, D]

    ks = vs = None
    if scale_pages is not None:
        scw = scale_pages[bt].reshape(b, seq, 128)
        ks, vs = scw[..., :h_kv], scw[..., h_kv:2 * h_kv]
    k_c = window(k_pages, ks)
    v_c = window(v_pages, vs)
    qg = q.float().reshape(b, m, h_kv, group, d)
    s = torch.einsum("bmkgd,bskd->bmkgs", qg, k_c) * scale
    limit = torch.clamp(base_len.long()[:, None]
                        + torch.arange(m, device=q.device)[None] + 1,
                        max=seq)  # [B, m]
    mask = (torch.arange(seq, device=q.device)[None, None]
            < limit[..., None])  # [B, m, S]
    s = torch.where(mask[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bmkgs,bskd->bmkgd", p, v_c).reshape(b, m, h, d)


def verify_body(q_dtype, kv_dtype, head_dim) -> str:
    """The body the verify kernel runs on the card, by the rule its wrapper
    passes to ``paged_verify_attention.cu``: ``"tensor_core"`` for bf16 q at
    D 64 and 128 with bf16 or int8 pages; ``"fma"`` for f32 at every D (its
    checks hold it to 1e-4, which bf16 products would break) and for bf16
    at D 256."""
    if (q_dtype == torch.bfloat16 and head_dim in _VERIFY_TC_HEAD_DIMS
            and kv_dtype in (torch.bfloat16, torch.int8)):
        return "tensor_core"
    return "fma"


def _verify_grid(m, num_heads, num_kv_heads):
    """(G, BQ, blocks per batch row) of the verify kernel's grid: G q heads
    of one GQA group share a block (the largest power of two up to 16
    dividing the group), BQ score rows (16, 32 or 64, the smallest that
    holds m * G) hold BQ // G query positions."""
    group = num_heads // num_kv_heads
    g = 1
    while g < 16 and group % (2 * g) == 0:
        g *= 2
    bq = next((r for r in (16, 32) if m * g <= r), 64)
    q_tiles = -(-m // (bq // g))
    return g, bq, q_tiles * num_kv_heads * (group // g)


def verify_chunk(capacity, splits) -> int:
    """Keys a split-K chunk walks: the window ``[0, capacity)`` cut into
    ``splits`` chunks, each rounded up to whole 64-key tiles."""
    per = -(-capacity // max(1, splits))
    return -(-per // _VERIFY_TILE) * _VERIFY_TILE


def verify_splits(batch, m, num_heads, num_kv_heads, capacity,
                  sm_count) -> int:
    """How many chunks the verify kernel cuts each row's window into
    (split-K), from host-known values only: the call never reads
    ``base_len`` and never waits for the card. One chunk when the grid
    (q tiles x batch x head groups) already holds ``_VERIFY_WARPS_PER_SM``
    warps an SM; else enough chunks to reach that, at most
    ``_VERIFY_MAX_SPLITS`` and never more than the window's 64-key tiles.
    The count is that of the chunks ``verify_chunk`` then makes, so no
    chunk lies wholly past the capacity."""
    _, bq, blocks = _verify_grid(m, num_heads, num_kv_heads)
    warps = batch * blocks * (bq // 16)
    want = _VERIFY_WARPS_PER_SM * sm_count
    if warps >= want:
        return 1
    tiles = -(-capacity // _VERIFY_TILE)
    splits = max(1, min(-(-want // warps), tiles, _VERIFY_MAX_SPLITS))
    return -(-capacity // verify_chunk(capacity, splits))


def paged_verify_chunked_ref(q, k_pages, v_pages, block_tables, base_len,
                             scale=None, scale_pages=None, splits=1,
                             bf16_p=False):
    """Plain twin of the verify kernel's split-K arithmetic: each row's
    window cut into the chunks of ``verify_chunk(capacity, splits)``, each
    chunk's softmax over its own keys (o normalised over them, and their
    log-sum-exp, -inf where the chunk holds no key of the row), then the
    chunks weighed in log space as the merge kernel weighs them. With
    ``bf16_p`` it takes the tensor-core body's rounding point instead of
    the reference's: the unnormalised P times each key's v scale rounded
    to bf16, against the raw (int8 or bf16) V values. Returns ``[B, m, H,
    D]`` f32."""
    b, m, h, d = q.shape
    _, page_size, khd = k_pages.shape
    h_kv = khd // d
    group = h // h_kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    seq = bt.shape[1] * page_size
    k_c = k_pages[bt].float().reshape(b, seq, h_kv, d)
    v_c = v_pages[bt].float().reshape(b, seq, h_kv, d)
    ks = vs = torch.ones((b, seq, h_kv), device=q.device)
    if scale_pages is not None:
        scw = scale_pages[bt].reshape(b, seq, 128).float()
        ks, vs = scw[..., :h_kv], scw[..., h_kv:2 * h_kv]
    qg = q.float().reshape(b, m, h_kv, group, d)
    s = torch.einsum("bmkgd,bskd->bmkgs", qg, k_c * ks[..., None]) * scale
    limit = torch.clamp(base_len.long()[:, None]
                        + torch.arange(m, device=q.device)[None] + 1,
                        max=seq)
    mask = (torch.arange(seq, device=q.device)[None, None]
            < limit[..., None])[:, :, None, None, :]  # [B, m, 1, 1, S]
    chunk = verify_chunk(seq, splits)
    outs, lses = [], []
    for lo in range(0, seq, chunk):
        hi = min(lo + chunk, seq)
        live = mask[..., lo:hi]
        sc = torch.where(live, s[..., lo:hi], torch.full_like(
            s[..., lo:hi], -math.inf))
        mx = sc.amax(-1, keepdim=True)
        empty = mx == -math.inf
        p = torch.where(live, torch.exp(sc - torch.where(
            empty, torch.zeros_like(mx), mx)), torch.zeros_like(sc))
        l_c = p.sum(-1, keepdim=True)
        if bf16_p:
            pv = p * vs[:, lo:hi].permute(0, 2, 1)[:, None, :, None, :]
            o = torch.einsum("bmkgs,bskd->bmkgd",
                             pv.to(torch.bfloat16).float(), v_c[:, lo:hi])
        else:
            o = torch.einsum("bmkgs,bskd->bmkgd", p,
                             v_c[:, lo:hi] * vs[:, lo:hi, :, None])
        outs.append(o / torch.clamp(l_c, min=1e-37))
        lses.append(torch.where(empty, mx, mx + torch.log(
            torch.clamp(l_c, min=1e-37))))
    lse = torch.stack(lses)                            # [C, B, m, k, g, 1]
    top = lse.amax(0)
    w = torch.where(lse == -math.inf, torch.zeros_like(lse),
                    torch.exp(lse - top))
    out = (w * torch.stack(outs)).sum(0) / torch.clamp(w.sum(0), min=1e-37)
    return out.reshape(b, m, h, d)


def paged_verify_slab_attention(q, k_pages, v_pages, block_tables, base_len,
                                scale=None,
                                scale_pages: Optional[torch.Tensor] = None):
    """Multi-query paged attention with a per-row base: q [B, m, H, D]
    against slab pages [P, page_size, Hkv*D]; query j of row b attends the
    window tokens ``< min(base_len[b] + j + 1, max_pages * page_size)``.
    ``scale_pages`` selects the int8 path. Returns ``[B, m, H, D]`` f32.
    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (``.launches`` counts them; ``.tc_launches`` those on the tensor-core
    body, ``verify_body``) or raises. Narrow calls cut each row's window
    into chunks (``verify_splits``) and merge them in a second kernel of
    the same launch. q may be strided (its last dim contiguous); the other
    operands must be contiguous."""
    return _paged_verify(q, k_pages, v_pages, block_tables, base_len, scale,
                         scale_pages)


_SM_COUNT = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _paged_verify(q, k_pages, v_pages, block_tables, base_len, scale=None,
                  scale_pages=None, body=None, splits=None):
    """``paged_verify_slab_attention`` with its body (``"tensor_core"`` or
    ``"fma"``) and its chunk count chosen by the caller instead of by
    ``verify_body`` and ``verify_splits``: how the card tests force split-K
    and how ``chip_smoke.py`` times the FMA body beside the tensor-core
    one."""
    _check(q, k_pages, v_pages, block_tables, base_len, scale_pages, 4)
    if q.device.type == "cpu":
        return paged_verify_slab_attention_ref(
            q, k_pages, v_pages, block_tables, base_len, scale, scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from ...kernels import build

    b, m, h, d = q.shape
    _, page_size, khd = k_pages.shape
    h_kv = khd // d
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"verify kernel takes f32 or bf16 q, got {q.dtype}")
    if k_pages.dtype not in (q.dtype, torch.int8):
        raise TypeError("pages must be q's dtype or int8")
    if d not in _VERIFY_HEAD_DIMS:
        raise ValueError(f"verify kernel takes head_dim in "
                         f"{_VERIFY_HEAD_DIMS}, got {d}")
    if block_tables.dtype != torch.int32 or base_len.dtype != torch.int32:
        raise TypeError("block_tables and base_len must be int32")
    if q.stride(3) != 1:
        raise ValueError("q must be contiguous in head_dim")
    tensors = [k_pages, v_pages, block_tables, base_len] + (
        [scale_pages] if scale_pages is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("verify kernel pages, tables and base_len must be "
                         "contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("verify kernel pages must be 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError("batch or heads too large for the kernel grid")
    rule = verify_body(q.dtype, k_pages.dtype, d)
    body = rule if body is None else body
    if body not in ("tensor_core", "fma") or (body == "tensor_core"
                                              and rule != body):
        raise ValueError(f"verify kernel has no {body!r} body for {q.dtype} "
                         f"q, {k_pages.dtype} pages at head_dim {d}")
    cap = block_tables.shape[1] * page_size
    if splits is None:
        splits = verify_splits(b, m, h, h_kv, cap, _sm_count(q.device))
    chunk = verify_chunk(cap, splits)
    splits = -(-cap // chunk)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, m, h, d), dtype=torch.float32, device=q.device)
    part_o = part_lse = None
    if splits > 1:
        part_o = torch.empty((splits, b, m, h, d), dtype=torch.float32,
                             device=q.device)
        part_lse = torch.empty((splits, b, m, h), dtype=torch.float32,
                               device=q.device)
    lib = build.load("paged_verify_attention")
    rc = lib.paged_verify_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        scale_pages.data_ptr() if scale_pages is not None else None,
        block_tables.data_ptr(), base_len.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if part_o is not None else None,
        part_lse.data_ptr() if part_lse is not None else None,
        b, m, h, h_kv, d, page_size, block_tables.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        float(scale), int(body == "tensor_core"), splits, chunk,
        build.stream_ptr(q.device))
    build.check(rc, "paged_verify_attention")
    paged_verify_slab_attention.launches += 1
    if body == "tensor_core":
        paged_verify_slab_attention.tc_launches += 1
    return out


launch_counter(paged_verify_slab_attention, "launches", "tc_launches")


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=None, k_scales=None, v_scales=None):
    """Plain twin of #4 (the JAX ``paged_decode_attention_ref``): gather
    each row's pages into a contiguous [B, Hkv, S, D] window (dequantized
    by the per-row scales), f32 logits masked at ``ids < lengths``,
    softmax, P.V, GQA by sharing each kv head over its group. A row of
    length 0 gives zeros (the kernel's guard). Returns [B, H, D] in q's
    dtype (the JAX twin returns f32, its kernel q's dtype)."""
    b, h, d = q.shape
    h_kv, _, page_size, _ = k_pages.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    seq = bt.shape[1] * page_size

    def window(pages, scales):
        win = pages[:, bt].float()  # [Hkv, B, max_pages, page_size, D]
        if scales is not None:
            win = win * scales[:, bt].float()[..., None]
        return win.transpose(0, 1).reshape(b, h_kv, seq, d)

    k_c = window(k_pages, k_scales)
    v_c = window(v_pages, v_scales)
    group = h // h_kv
    qg = q.reshape(b, h_kv, group, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_c) * scale
    lens = lengths.long()
    ids = torch.arange(seq, device=q.device)[None, None, None, :]
    s = torch.where(ids < lens[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_c).reshape(b, h, d)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           scale=None, k_scales=None, v_scales=None):
    """#4: q [B, H, D] (a unit stride over D; other operands contiguous)
    against head-major pages [Hkv, P, page_size, D];
    block_tables [B, max_pages] i32; lengths [B] i32 (the new token already
    written). ``k_scales``/``v_scales`` f32 [Hkv, P, page_size] select the
    int8 path (pages must then be int8). Returns [B, H, D] in q's dtype. A
    CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (``.launches`` counts them) or raises. Each window is cut into
    ``decode_splits`` chunks on the card and merged in the same launch."""
    return _paged_decode(q, k_pages, v_pages, block_tables, lengths, scale,
                         k_scales, v_scales)


def _paged_decode(q, k_pages, v_pages, block_tables, lengths, scale=None,
                  k_scales=None, v_scales=None, splits=None):
    """``paged_decode_attention`` with its chunk count chosen by the caller
    instead of by ``decode_splits`` (``splits=1``: the unsplit body), for
    the card tests and ``chip_smoke.py``."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q [B, H, D], pages [Hkv, P, page_size, D]")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k and v pages must match in shape and dtype")
    b, h, d = q.shape
    h_kv, num_pages, page_size, pd = k_pages.shape
    if pd != d or h % h_kv:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("block_tables must be [B, max_pages]")
    if tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be [B]")
    quantized = k_scales is not None
    if quantized != (v_scales is not None) or quantized != (
            k_pages.dtype == torch.int8):
        raise TypeError("int8 pages need k_scales and v_scales, other pages "
                        "none")
    scales = [k_scales, v_scales] if quantized else []
    if any(tuple(s.shape) != (h_kv, num_pages, page_size) for s in scales):
        raise ValueError("scales must be [Hkv, P, page_size]")
    tensors = [q, k_pages, v_pages, block_tables, lengths] + scales
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must live on one device")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, scale, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from ...kernels import build

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes f32 or bf16 q, got {q.dtype}")
    if k_pages.dtype not in (q.dtype, torch.int8):
        raise TypeError("pages must be q's dtype or int8")
    if quantized and any(s.dtype != torch.float32 for s in scales):
        raise TypeError("int8 page scales must be f32")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {_HEAD_DIMS}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if q.stride(2) != 1 or not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("decode kernel operands must be contiguous (q in "
                         "head_dim)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if splits is None:
        splits = decode_splits(b, h, h_kv, block_tables.shape[1] * page_size,
                               _sm_count(q.device))
    part_o, part_lse, counters = _decode_split_args(q.device, b, h, d,
                                                    splits)
    min_chunk = decode_min_chunk(b, h, h_kv, _sm_count(q.device))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lib = build.load("paged_decode_attention_v1")
    rc = lib.paged_decode_attention_v1(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, h_kv, d, num_pages, page_size, block_tables.shape[1],
        q.stride(0), q.stride(1),
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        float(scale), int(splits), min_chunk, _ptr(part_o), _ptr(part_lse),
        _ptr(counters), build.stream_ptr(q.device))
    build.check(rc, "paged_decode_attention_v1")
    paged_decode_attention.launches += 1
    return out


launch_counter(paged_decode_attention, "launches")


class PagedKVCache:
    """Host-side page pool and block tables for one transformer layer
    (the reference's ``PagedKVCache``).

    Pages ``[Hkv, P, page_size, D]`` (int8 with f32 per-row scales when
    ``quantized``) are tensors on ``device`` (CUDA unless ``device="cpu"``),
    written in place. Allocation bookkeeping (free list, per-slot block
    tables, lengths) is host numpy, as in serving engines; each write or
    attend sends its indices to the device in one copy. ``batch_size``
    slots are sequence slots; ``free`` recycles a slot's pages."""

    def __init__(self, num_pages: int, page_size: int, batch_size: int,
                 num_kv_heads: int, head_dim: int, max_pages_per_seq: int,
                 dtype=torch.bfloat16, quantized: bool = False, device=None):
        from ...framework.device import resolve_device, resolve_dtype

        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages = max_pages_per_seq
        self.quantized = bool(quantized)
        self.device = resolve_device(device)
        store = torch.int8 if quantized else resolve_dtype(dtype)
        shape = (num_kv_heads, num_pages, page_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        if quantized:
            self.k_scales = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        else:
            self.k_scales = self.v_scales = None
        self.block_tables = np.zeros((batch_size, max_pages_per_seq),
                                     np.int32)
        self.lengths = np.zeros((batch_size,), np.int32)
        self._free = list(range(num_pages - 1, -1, -1))

    # -- allocation ----------------------------------------------------
    def _ensure_pages(self, slot: int, new_len: int):
        need = (new_len + self.page_size - 1) // self.page_size
        have = (self.lengths[slot] + self.page_size - 1) // self.page_size
        if need > self.max_pages:
            raise ValueError(f"sequence exceeds max_pages={self.max_pages}")
        for i in range(have, need):
            if not self._free:
                raise RuntimeError("KV page pool exhausted")
            self.block_tables[slot, i] = self._free.pop()

    def free(self, slot: int):
        used = (int(self.lengths[slot]) + self.page_size - 1) // self.page_size
        self._free.extend(int(p) for p in self.block_tables[slot, :used])
        self.block_tables[slot, :] = 0
        self.lengths[slot] = 0

    # -- writes --------------------------------------------------------
    def _to_device(self, *arrays, dtype=np.int64):
        """Host int arrays → contiguous device tensors, in one copy."""
        flat = np.concatenate([np.asarray(a, dtype).ravel()
                               for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, at = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(dev[at:at + n].view(np.shape(a)))
            at += n
        return out

    def _write(self, phys, slots, k, v):
        """k/v [Hkv, *idx.shape, D] into (head, phys, slot)."""
        idx = (slice(None),) + tuple(self._to_device(phys, slots))
        if self.quantized:
            kq, ks = quantize_rows_int8(k)
            vq, vs = quantize_rows_int8(v)
            self.k_scales[idx] = ks
            self.v_scales[idx] = vs
            k, v = kq, vq
        self.k_pages[idx] = k.to(self.k_pages.dtype)
        self.v_pages[idx] = v.to(self.v_pages.dtype)

    def append(self, k, v):
        """Append ONE token per slot: k/v [B, Hkv, D] at each slot's current
        length (slots must all be active)."""
        bsz = k.shape[0]
        phys = np.empty((bsz,), np.int64)
        slots = np.empty((bsz,), np.int64)
        for bidx in range(bsz):
            t = int(self.lengths[bidx])
            self._ensure_pages(bidx, t + 1)
            phys[bidx] = self.block_tables[bidx, t // self.page_size]
            slots[bidx] = t % self.page_size
        # [B, Hkv, D] → [Hkv, B, D] at (head, phys[b], slot[b])
        self._write(phys, slots, k.transpose(0, 1), v.transpose(0, 1))
        self.lengths[:bsz] += 1

    def prefill(self, k, v):
        """Write a whole prompt: k/v [B, S0, Hkv, D] into fresh slots."""
        bsz, s0 = k.shape[:2]
        for bidx in range(bsz):
            if self.lengths[bidx]:
                raise ValueError("prefill into non-empty slot; free() first")
            self._ensure_pages(bidx, s0)
        logical = np.arange(s0)
        phys = self.block_tables[:bsz, logical // self.page_size]  # [B,S0]
        slots = np.broadcast_to(logical % self.page_size, (bsz, s0))
        # [B, S0, Hkv, D] → [Hkv, B, S0, D]
        self._write(phys, slots, k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3))
        self.lengths[:bsz] += s0

    # -- attend --------------------------------------------------------
    def attend(self, q):
        """Decode attention for the current state (#4): q [B, H, D] → [B,
        H, D] in q's dtype."""
        tables, lengths = self._to_device(self.block_tables, self.lengths,
                                          dtype=np.int32)
        return paged_decode_attention(
            q, self.k_pages, self.v_pages, tables, lengths,
            k_scales=self.k_scales, v_scales=self.v_scales)


def paged_multi_query_attention(q, state, base_len, scale=None):
    """The one multi-position entry the spec verifier, the prefix-cache
    suffix prefill and chunked prefill ride: the verify kernel over
    ``state``'s pages (its plain twin for CPU tensors)."""
    return paged_verify_slab_attention(
        q, state.k_pages, state.v_pages, state.block_tables,
        base_len.to(torch.int32), scale=scale,
        scale_pages=state.scale_pages)
