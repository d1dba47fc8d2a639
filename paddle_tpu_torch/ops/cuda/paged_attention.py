"""Paged KV cache state and slab-paged decode attention.

Port of the functional serving path of
``paddle_tpu/ops/pallas/paged_attention.py``: ``PagedCacheState``,
``quantize_rows_int8``, ``_store_rows``, ``paged_state_prefill``,
``paged_state_step``, the ``PagedCacheState`` branch of ``paged_forward``,
and ``paged_slab_decode_attention`` (TPU kernel ``_paged_slab_kernel``)
with its plain twin. The CUDA source is
``paddle_tpu_torch/csrc/paged_decode_attention.cu``.

Page layout, as in the reference: data pages ``[P, page_size, Hkv*D]``
(heads side by side in one slab row); physical page 0 is the trash page
that idle slots and padding write into; int8 pages carry a bf16 scale page
``[P, page_size, 128]`` with k scales at lanes ``[0, Hkv)`` and v scales at
``[Hkv, 2*Hkv)``.

Unlike the JAX version, page writes happen IN PLACE (``index_put_``) on the
state's page tensors: the returned state shares them. Lengths are new
tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["PagedCacheState", "quantize_rows_int8", "paged_state_prefill",
           "paged_state_step", "paged_forward",
           "paged_slab_decode_attention", "paged_slab_decode_attention_ref"]

NEG_INF = -1.0e30
_HEAD_DIMS = (32, 64, 128, 256)


class PagedCacheState:
    """One layer's paged cache as the engine threads it through a forward:
    pages, block tables ``[B, max_pages]`` i32 and lengths ``[B]`` i32, all
    tensors on one device. ``lengths[b] == 0`` marks an idle slot: its
    writes go to the trash page and its output is discarded.
    ``prefill_valid`` ([B] i32) marks an admission forward and carries each
    row's valid prompt width."""

    def __init__(self, k_pages, v_pages, scale_pages, block_tables, lengths,
                 page_size, prefill_valid=None, verify=False):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.scale_pages = scale_pages
        self.block_tables = block_tables
        self.lengths = lengths
        self.page_size = int(page_size)
        self.prefill_valid = prefill_valid
        self.verify = bool(verify)

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
                      prefill_valid=self.prefill_valid, verify=self.verify)
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


def _write(state, phys, slotpos, k, v):
    kq, vq, sc = _store_rows(state, k, v)
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


def paged_forward(cache, q, k, v, context_attention):
    """Model-side paged-cache step for one attention layer. q/k/v
    [b, s, heads, head_dim]. With ``prefill_valid`` set (every admission)
    or a multi-token input this is a prefill: the prompt is written and
    ``context_attention()`` gives the output. Otherwise one decode token
    per slot. Returns ``(out, new_state)``."""
    if not isinstance(cache, PagedCacheState):
        raise TypeError("paged_forward takes a PagedCacheState")
    if cache.verify:
        raise NotImplementedError(
            "multi-query verify attention (prefix cache, chunked prefill, "
            "spec decode) is not ported yet")
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


def _check(q, k_pages, v_pages, block_tables, lengths, scale_pages):
    if q.dim() != 3 or k_pages.dim() != 3:
        raise ValueError("q [B, H, D] and pages [P, page_size, Hkv*D]")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k and v pages must match in shape and dtype")
    b, h, d = q.shape
    khd = k_pages.shape[2]
    if khd % d:
        raise ValueError(f"page lanes ({khd}) must hold whole KV heads of "
                         f"head_dim={d}")
    if h % (khd // d):
        raise ValueError("q heads must be a multiple of kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("block_tables must be [B, max_pages]")
    if lengths.shape != (b,):
        raise ValueError("lengths must be [B]")
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


def paged_slab_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                num_heads=None, scale=None,
                                scale_pages: Optional[torch.Tensor] = None):
    """Slab-paged decode attention: q [B, H, D]; pages [P, page_size,
    Hkv*D]; block_tables [B, max_pages] i32; lengths [B] i32 (the new token
    already written). ``scale_pages`` selects the int8 path. Returns
    [B, H, D] in q's dtype. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel (``.launches`` counts them) or raises."""
    _check(q, k_pages, v_pages, block_tables, lengths, scale_pages)
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
    out = torch.empty_like(q)
    lib = build.load("paged_decode_attention")
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        scale_pages.data_ptr() if scale_pages is not None else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, khd // d, d, page_size, block_tables.shape[1],
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pages.dtype],
        float(scale), build.stream_ptr(q.device))
    build.check(rc, "paged_decode_attention")
    paged_slab_decode_attention.launches += 1
    return out


paged_slab_decode_attention.launches = 0
