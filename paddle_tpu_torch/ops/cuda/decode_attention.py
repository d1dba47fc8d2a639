"""Single-token decode attention over a contiguous KV cache, and the cache
plumbing of the generation loop.

Port of ``paddle_tpu/ops/pallas/decode_attention.py``: the plain versions
``decode_attention_ref`` and ``_slab_ref``; ``decode_attention`` (TPU
kernel ``decode_attention_pallas``, #14) and ``decode_attention_slab``
(TPU kernel ``_slab_pallas``, #15), both on the CUDA source
``paddle_tpu_torch/csrc/decode_attention.cu``; and ``make_kv_slab``,
``cache_prefill_write`` and ``cache_decode_step``, which dispatch on the
cache's rank as the reference does:

* 4-D: the slab ``[2, B, S, Hkv*D]`` (what ``init_caches`` allocates);
* 5-D: the reference layout ``[2, B, Hkv, S, D]`` (user-allocated caches,
  ``masked_multihead_attention``).

``lengths`` count the valid rows INCLUDING the new token (already written
at ``lengths - 1``). GQA: q head h reads kv head ``h // (H // Hkv)``, read
natively (no repeat of K/V).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. The reference's ``FLAGS_decode_attention_kernel`` (which
picks between two TPU implementations) and its 128-lane gate on the slab
are TPU matters and are not ported: on the card #14 and #15 always run,
and a head dim other than 32, 64, 128 or 256 raises.

A row of length 0 gives zeros in the kernels and in the plain versions
(the reference's ``decode_attention_ref`` gives the mean of V over the
window there, and its Pallas #14 the mean over the padded window; no caller
passes 0: generation passes ``time_step + 1``).

Gradients: as the reference's ``custom_vjp``, the forward is the
dispatch and the backward is autograd through the plain version (no
backward kernel).

Unlike the JAX version, the caches are written IN PLACE: ``cache_*``
return the same tensor they were given.
"""
from __future__ import annotations

import math

import torch

from ...kernels.build import launch_counter

__all__ = ["decode_attention", "decode_attention_ref",
           "decode_attention_slab", "make_kv_slab", "cache_prefill_write",
           "cache_decode_step"]

NEG_INF = -1.0e30
_HEAD_DIMS = (32, 64, 128, 256)


def decode_attention_ref(q, k_cache, v_cache, lengths, scale=None):
    """Plain version: f32 logits over the whole window, masked at
    ``ids < lengths``, softmax, P.V, GQA grouped by reshape. q [B, H, D],
    caches [B, Hkv, S, D], lengths [B] → [B, H, D] in q's dtype; a row of
    length 0 gives zeros."""
    b, h, d = q.shape
    h_kv, s_max = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = h // h_kv
    qg = q.reshape(b, h_kv, group, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    lens = lengths.to(device=q.device).long()
    ids = torch.arange(s_max, device=q.device)[None, None, None, :]
    s = torch.where(ids < lens[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float()).reshape(b, h, d)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _slab_views(kv_slab, d):
    """The slab's K and V halves seen as [B, Hkv, S, D] (views)."""
    _, b, s_max, khd = kv_slab.shape
    kv = kv_slab.unflatten(3, (khd // d, d)).transpose(2, 3)
    return kv[0], kv[1]


def _slab_ref(q, kv_slab, lengths, scale=None):
    """Plain version of the slab kernel: ``decode_attention_ref`` over the
    slab's halves."""
    k, v = _slab_views(kv_slab, q.shape[-1])
    return decode_attention_ref(q, k, v, lengths, scale)


def _launch(q, k, v, lengths, scale, counter, splits=None):
    """#14/#15 on CUDA tensors: k, v [B, Hkv, S, D] views with a unit
    stride over D (the 5-D cache's halves or the slab's). Each window is
    cut into ``splits`` chunks on the card (``decode_splits`` when None;
    ``splits=1`` is the unsplit body, which the card tests and
    ``chip_smoke.py`` force through this entry)."""
    from ...kernels import build
    from .paged_attention import (_decode_split_args, _ptr, _sm_count,
                                  decode_min_chunk, decode_splits)

    b, h, d = q.shape
    h_kv, s_max = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes f32 or bf16 q, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the cache must be q's dtype")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if k.stride() != v.stride() or q.stride(2) != 1 or k.stride(3) != 1:
        raise ValueError("q and the caches need a unit stride over head_dim,"
                         " and k and v one layout")
    vec = 16 // q.element_size()
    if any(st % vec for st in k.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("cache rows must start on 16-byte boundaries")
    if lengths.dtype != torch.int32:
        lengths = lengths.to(torch.int32)
    lengths = lengths.contiguous()
    if splits is None:
        splits = decode_splits(b, h, h_kv, s_max, _sm_count(q.device))
    part_o, part_lse, counters = _decode_split_args(q.device, b, h, d,
                                                    splits)
    min_chunk = decode_min_chunk(b, h, h_kv, _sm_count(q.device))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lib = build.load("decode_attention")
    dt = build.DTYPE_CODES[q.dtype]
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, h_kv, d, s_max, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2), dt, dt, float(scale),
        int(splits), min_chunk, _ptr(part_o), _ptr(part_lse),
        _ptr(counters), build.stream_ptr(q.device))
    build.check(rc, "decode_attention")
    counter.launches += 1
    return out


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q [B, H, D], caches [B, Hkv, S, D]")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"caches {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be [B]")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("all operands must live on one device")


def _forward(q, k, v, lengths, scale, counter):
    """The dispatch: the plain version for CPU tensors, the kernel
    (counted on ``counter.launches``) for CUDA tensors."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, lengths, scale, counter)


class _Decode(torch.autograd.Function):
    """Forward: the dispatch; backward: autograd through
    ``decode_attention_ref`` (the reference's custom_vjp rule)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, counter):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, lengths)
        return _forward(q, k, v, lengths, scale, counter)

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = decode_attention_ref(*ins, lengths, ctx.scale)
            grads = torch.autograd.grad(out, ins, g)
        return tuple(grads) + (None, None, None)


def _apply(q, k, v, lengths, scale, counter):
    _check(q, k, v, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Decode.apply(q, k, v, lengths, scale, counter)
    return _forward(q, k, v, lengths, scale, counter)


def decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """#14: q [B, H, D], k/v caches [B, Hkv, S, D] (views with a unit stride
    over D), lengths [B] → [B, H, D] in q's dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (``.launches`` counts
    them) or raises. Differentiable (backward through the plain
    version)."""
    return _apply(q, k_cache, v_cache, lengths, scale, decode_attention)


launch_counter(decode_attention, "launches")


def decode_attention_slab(q, kv_slab, lengths, scale=None):
    """#15: q [B, H, D], kv_slab [2, B, S, Hkv*D] (any view whose last dim
    is contiguous), lengths [B] → [B, H, D] in q's dtype. Dispatch and
    gradients as :func:`decode_attention`; launches are counted on
    ``decode_attention_slab.launches``."""
    if kv_slab.dim() != 4 or kv_slab.shape[0] != 2:
        raise ValueError("kv_slab must be [2, B, S, Hkv*D]")
    if kv_slab.shape[-1] % q.shape[-1]:
        raise ValueError("slab lanes must hold whole kv heads")
    k, v = _slab_views(kv_slab, q.shape[-1])
    return _apply(q, k, v, lengths, scale, decode_attention_slab)


launch_counter(decode_attention_slab, "launches")


# ------------------------------------------------- shared cache plumbing


def make_kv_slab(batch, max_seq, num_kv_heads, head_dim,
                 dtype=torch.float32, device=None):
    """A zeroed slab cache ``[2, batch, max_seq, num_kv_heads*head_dim]``
    on ``device`` (CUDA unless ``device="cpu"``)."""
    from ...framework.device import resolve_device

    return torch.zeros((2, batch, max_seq, num_kv_heads * head_dim),
                       dtype=dtype, device=resolve_device(device))


def _layout(cache):
    if not isinstance(cache, torch.Tensor) or cache.dim() not in (4, 5):
        raise TypeError("a contiguous KV cache is a tensor [2, B, S, Hkv*D] "
                        "(slab) or [2, B, Hkv, S, D]; got "
                        f"{type(cache).__name__}")
    return cache.dim()


def cache_prefill_write(cache, k, v):
    """Write the prompt's k/v ([b, s, Hkv, D]) into the cache at positions
    [0, s), in place. Returns the cache."""
    b, s = k.shape[0], k.shape[1]
    if _layout(cache) == 4:
        cache[0, :b, :s] = k.reshape(b, s, -1)
        cache[1, :b, :s] = v.reshape(b, s, -1)
    else:
        cache[0, :b, :, :s] = k.transpose(1, 2)
        cache[1, :b, :, :s] = v.transpose(1, 2)
    return cache


def cache_decode_step(cache, q, k, v, time_step, scale=None):
    """Append one token's k/v ([b, 1, Hkv, D]) at ``time_step`` (an int or a
    0-d/1-element tensor on the cache's device: no host sync) and attend q
    ([b, 1, H, D]) over the cache's first ``time_step + 1`` rows: #15 on
    the slab, #14 on the 5-D layout. Returns (out [b, 1, H, D], cache)."""
    rank = _layout(cache)
    b = q.shape[0]
    qh = q[:, 0]  # [b, H, D]
    if isinstance(time_step, torch.Tensor):
        ts = time_step.reshape(1).to(device=cache.device, dtype=torch.long)
        lengths = (ts + 1).to(torch.int32).expand(b)
        upd = torch.stack([k[:, 0], v[:, 0]]).to(cache.dtype)  # [2,b,Hkv,D]
        if rank == 4:
            cache.index_copy_(2, ts, upd.reshape(2, b, 1, -1))
        else:
            cache.index_copy_(3, ts, upd[:, :, :, None])
    else:
        ts = int(time_step)
        lengths = torch.full((b,), ts + 1, dtype=torch.int32,
                             device=cache.device)
        if rank == 4:
            cache[0, :, ts] = k[:, 0].reshape(b, -1)
            cache[1, :, ts] = v[:, 0].reshape(b, -1)
        else:
            cache[0, :, :, ts] = k[:, 0]
            cache[1, :, :, ts] = v[:, 0]
    if rank == 4:
        out = decode_attention_slab(qh, cache, lengths, scale)
    else:
        out = decode_attention(qh, cache[0], cache[1], lengths, scale)
    return out[:, None], cache
