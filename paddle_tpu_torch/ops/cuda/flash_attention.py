"""Flash attention forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function over both.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` ``flash_attention_fused``
and ``flash_attention_with_lse``. The forward kernel (TPU kernel #2,
``_fwd_kernel``) is ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``; the
backward kernel, which replaces both the fused whole-sequence backward (#5,
``_bwd_fused``) and the split dK/dV and dQ kernels (#6, ``_bwd``), is
``paddle_tpu_torch/csrc/flash_attention_bwd.cu``. Both are bound by the
tensor cores' bf16 rate at every shape the port runs (thousands of flops
per byte moved).

Each kernel has two bodies, chosen by dtype and head dim (``flash_body``):
bf16 at D 64 and 128 runs on the tensor cores (FlashAttention-2's design
on ``mma.sync``: tiles staged in bf16 shared memory by ``cp.async``, the
softmax on the accumulators in registers, P and dS rounded to bf16 straight
into the next product's operands); f32 at every D, and bf16 at D 32 and 256
(no model on the port's paths uses them), run on f32 FMAs, so f32 keeps
full-precision products. The tensor-core body copies 16 bytes at a time:
each operand's base and (batch, seq, head) strides must be multiples of 16
bytes, and ``check_tc_alignment`` refuses others, naming the operand.

Layout ``[B, S, H, D]`` in and out (the paddle flash_attention layout); the
kernels read every operand through its strides (last dim contiguous), so
no ``[B*H, S, D]`` copy is made and q, k, v may be views of one packed
tensor. Causality is top-left aligned (query i sees keys j <= i), as in the
Pallas kernels. In the forward k/v may carry fewer heads than q (GQA: q
head h reads kv head ``h // (H // Hkv)``); the backward takes as many k/v
heads as q heads (LLaMA repeats them first, as the reference does).

Position mode (the reference's ``q_positions`` / ``kv_positions``, which
ring attention passes on every ring step): each query and key carries its
global token index; query i sees key j iff ``q_pos[i] >= kv_pos[j]`` and
``causal`` is ignored. The positions are int32 on q's device (the
reference's f32 holds the same values below 2**24). A row that sees no key
gives ``out = 0`` and ``lse = -1e30``, the reference's ``NEG_INF``, which
the ring's log-space merge weighs as nothing.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches``
count kernel launches; ``.tc_launches`` counts those on the tensor-core body
and ``.pos_launches`` those in position mode (both included in
``.launches``). Each library picks its body at compile time and builds no
FMA body for bf16 at D 64 or 128, so ``flash_body`` tells which body a
launch ran.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ...kernels.build import count_launch, launch_counter

__all__ = ["flash_attention_fwd", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "FlashAttentionFunction",
           "flash_attention_fused", "flash_attention_with_lse", "flash_body",
           "check_tc_alignment"]

_DTYPES = (torch.float32, torch.bfloat16)
NO_KEY_LSE = -1.0e30  # lse of a row that sees no key (the reference's NEG_INF)
_HEAD_DIMS = (32, 64, 128, 256)
_BWD_HEAD_DIMS = (64, 128, 256)
_TC_HEAD_DIMS = (64, 128)


def flash_body(dtype, head_dim) -> str:
    """The body a flash kernel runs for ``dtype`` at ``head_dim`` on the
    card, by the rule of both ``.cu`` files' launch code:
    ``"tensor_core"`` for bf16 at D 64 and 128, ``"fma"`` for f32 at every
    D (its checks hold it to 1e-4, which TF32 products would break) and for
    bf16 at D 32 and 256."""
    if dtype == torch.bfloat16 and head_dim in _TC_HEAD_DIMS:
        return "tensor_core"
    return "fma"


def check_tc_alignment(*named):
    """Refuse an operand the tensor-core body cannot copy: its 16-byte
    ``cp.async`` copies and stores need each ``(name, tensor)``'s base
    address and its (batch, seq, head) strides in bytes to be multiples of
    16 (a stride of a dim of size 1 is never used). Raises ``ValueError``
    naming the operand."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core flash kernel needs a "
                             f"16-byte aligned base address, got "
                             f"{t.data_ptr():#x}")
        for dim, what in enumerate(("batch", "seq", "head")):
            nbytes = t.stride(dim) * t.element_size()
            if t.shape[dim] > 1 and nbytes % 16:
                raise ValueError(f"{name}: the tensor-core flash kernel "
                                 f"needs a {what} stride of a multiple of 16 "
                                 f"bytes, got {nbytes}")


def _launched(fn, tensor_core, positions):
    """Count one launch of ``fn``'s kernel, on the tensor-core body when
    ``tensor_core``, in position mode when ``positions``."""
    count_launch(fn, "launches",
                 *(("tc_launches",) if tensor_core else ()),
                 *(("pos_launches",) if positions else ()))


def _positions(q_positions, kv_positions, sq, sk, device):
    """Both position arrays as int32 ``[Sq]`` / ``[Sk]`` on ``device``, or
    ``(None, None)``: the one conversion, made where the autograd Function
    takes them. One without the other raises (the reference raises for
    ``q_positions`` alone and ignores ``kv_positions`` alone)."""
    if q_positions is None or kv_positions is None:
        _check_positions(q_positions, kv_positions, sq, sk, device)
        return None, None
    qp, kp = (torch.as_tensor(p) for p in (q_positions, kv_positions))
    for name, p in (("q_positions", qp), ("kv_positions", kp)):
        if p.dtype.is_floating_point or p.dtype == torch.bool:
            raise TypeError(f"{name} must hold integer token indices")
    qp, kp = (p.to(device=device, dtype=torch.int32).contiguous()
              for p in (qp, kp))
    _check_positions(qp, kp, sq, sk, device)
    return qp, kp


def _check_positions(qp, kp, sq, sk, device):
    """Refuse positions that are not both int32 ``[Sq]`` / ``[Sk]`` on
    ``device`` (or both None), as the kernels and their twins take them."""
    if qp is None and kp is None:
        return
    if qp is None or kp is None:
        raise ValueError("q_positions and kv_positions go together: one "
                         "was given without the other")
    for name, p, n in (("q_positions", qp, sq), ("kv_positions", kp, sk)):
        if not isinstance(p, torch.Tensor) or p.dtype != torch.int32:
            raise TypeError(f"{name} must hold integer token indices as an "
                            f"int32 tensor, got "
                            f"{getattr(p, 'dtype', type(p).__name__)}")
        if tuple(p.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(p.shape)}, expected "
                             f"({n},)")
        if p.device != torch.device(device) or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _keep_mask(sq, sk, causal, device, qp=None, kp=None):
    if qp is not None:
        return qp[:, None] >= kp[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    return torch.tril(keep) if causal else keep


def flash_attention_ref(q, k, v, causal=True, scale=None, return_lse=False,
                        q_positions=None, kv_positions=None):
    """Plain PyTorch twin of the forward kernel: f32 logits and softmax, P
    rounded to the input dtype before the P.V product (f32 accumulation),
    rows with no key give zeros and lse -1e30. With positions the mask is
    ``q_pos[i] >= kv_pos[j]`` and ``causal`` is ignored. Returns ``out [B,
    Sq, H, D]`` in q's dtype, plus ``lse [B, H, Sq]`` f32 when
    ``return_lse``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qp, kp = q_positions, kv_positions
    _check_positions(qp, kp, sq, sk, q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~_keep_mask(sq, sk, causal, q.device, qp, kp),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    dead = torch.isinf(m)  # the row sees no key
    m = torch.where(dead, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    pr = p.to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", pr, v.float()) / \
        l.permute(0, 2, 1, 3)
    out = out.to(q.dtype)
    if return_lse:
        lse = torch.where(dead, torch.full_like(m, NO_KEY_LSE),
                          m + torch.log(l))
        return out, lse[..., 0]
    return out


def flash_attention_bwd_ref(q, k, v, out, do, lse, dlse=None, causal=True,
                            scale=None, q_positions=None, kv_positions=None):
    """Plain PyTorch twin of the backward kernel (the recompute scheme of
    the reference's ``fused_bwd_math`` / ``_bwd``): ``P = exp(S*scale -
    lse)`` with masked entries exactly 0 (with positions, the mask of the
    forward's position mode), ``delta = rowsum(dO*O) - dlse`` in f32, P and
    dS rounded to the input dtype before their products, f32 accumulation.
    Returns ``(dq, dk, dv)`` in q's dtype."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    qp, kp = q_positions, kv_positions
    _check_positions(qp, kp, sq, sk, q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    keep = _keep_mask(sq, sk, causal, q.device, qp, kp)
    p = torch.where(keep, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    delta = (gf * of).sum(-1).transpose(1, 2)                 # [B, H, Sq]
    if dlse is not None:
        delta = delta - dlse.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({k.shape[2]})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must live on one device")


def _check_like(name, t, shape, ref):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != ref.dtype or t.device != ref.device:
        raise TypeError(f"{name} must match q's dtype and device")


def _cuda_checks(q, head_dims, *named):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, _, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    if d not in head_dims:
        raise ValueError(f"flash kernel takes head_dim in {head_dims}, "
                         f"got {d}")
    for name, t in named:
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel grid")


def flash_attention_fwd(q, k, v, causal=True, scale=None, return_lse=False,
                        out: Optional[torch.Tensor] = None, q_positions=None,
                        kv_positions=None):
    """Flash attention forward on ``[B, S, H, D]`` tensors. Returns ``out``
    (and ``lse [B, H, Sq]`` f32 when ``return_lse``). ``out``, when given,
    is a ``[B, Sq, H, D]`` tensor in any strides (contiguous last dim) that
    the kernel writes in place, such as a view into a packed buffer.
    ``q_positions`` [Sq] / ``kv_positions`` [Sk], int32 on q's device,
    select position mode."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    qp, kp = q_positions, kv_positions
    _check_positions(qp, kp, sq, k.shape[1], q.device)
    if out is not None:
        _check_like("out", out, (b, sq, h, d), q)
    if q.device.type == "cpu":
        res = flash_attention_ref(q, k, v, causal, scale, return_lse, qp, kp)
        if out is None:
            return res
        out.copy_(res[0] if return_lse else res)
        return (out, res[1]) if return_lse else out
    named = [("q", q), ("k", k), ("v", v)]
    if out is not None:
        named.append(("out", out))
    _cuda_checks(q, _HEAD_DIMS, *named)
    tensor_core = flash_body(q.dtype, d) == "tensor_core"
    if tensor_core:
        check_tc_alignment(*named)
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    from ...kernels import build

    if out is None:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = (
        torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if return_lse else None)
    lib = build.load("flash_attention_fwd")
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        qp.data_ptr() if qp is not None else None,
        kp.data_ptr() if kp is not None else None,
        b, h, hkv, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(bool(causal)), float(scale), build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q.device))
    build.check(rc, "flash_attention_fwd")
    _launched(flash_attention_fwd, tensor_core, qp is not None)
    return (out, lse) if return_lse else out


launch_counter(flash_attention_fwd, "launches", "tc_launches",
               "pos_launches")


def flash_attention_bwd(q, k, v, out, do, lse, dlse=None, causal=True,
                        scale=None,
                        grads: Optional[Sequence[torch.Tensor]] = None,
                        q_positions=None, kv_positions=None):
    """Flash attention backward. q, out, do ``[B, Sq, H, D]``; k, v ``[B,
    Sk, H, D]``; lse (and the optional lse cotangent dlse) ``[B, H, Sq]``
    f32, as the forward wrote it. Returns ``(dq, dk, dv)`` in q's dtype.
    ``grads``, when given, is ``(dq, dk, dv)`` preallocated in any strides
    (contiguous last dim), such as views into one packed dQKV buffer; the
    kernel writes them in place. The positions are the forward's."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qp, kp = q_positions, kv_positions
    _check_positions(qp, kp, sq, sk, q.device)
    if k.shape[2] != h:
        raise ValueError(f"the flash backward takes as many k/v heads as q "
                         f"heads ({k.shape[2]} != {h}); repeat them first")
    _check_like("out", out, q.shape, q)
    _check_like("do", do, q.shape, q)
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (tuple(t.shape) != (b, h, sq)
                              or t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError(f"{name} must be f32 [B, H, Sq] = "
                             f"{(b, h, sq)} on q's device")
    if grads is not None:
        for name, t, ref in zip(("dq", "dk", "dv"), grads, (q, k, v)):
            _check_like(name, t, ref.shape, q)
    if q.device.type == "cpu":
        res = flash_attention_bwd_ref(q, k, v, out, do, lse, dlse, causal,
                                      scale, qp, kp)
        if grads is None:
            return res
        for dst, src in zip(grads, res):
            dst.copy_(src)
        return tuple(grads)
    if do.stride(3) != 1:
        do = do.contiguous()
    if grads is None:
        grads = (torch.empty_like(q, memory_format=torch.contiguous_format),
                 torch.empty_like(k, memory_format=torch.contiguous_format),
                 torch.empty_like(v, memory_format=torch.contiguous_format))
    named = tuple(zip(("q", "k", "v", "out", "do", "dq", "dk", "dv"),
                      (q, k, v, out, do) + tuple(grads)))
    _cuda_checks(q, _BWD_HEAD_DIMS, *named)
    tensor_core = flash_body(q.dtype, d) == "tensor_core"
    if tensor_core:
        check_tc_alignment(*named)
    lse = lse.contiguous()
    dlse = dlse.contiguous() if dlse is not None else None
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    from ...kernels import build

    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[t.stride(i) for _, t in named for i in range(3)])
    lib = build.load("flash_attention_bwd")
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        dlse.data_ptr() if dlse is not None else None,
        grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
        delta.data_ptr(), qp.data_ptr() if qp is not None else None,
        kp.data_ptr() if kp is not None else None, b, h, sq, sk, d,
        strides, int(bool(causal)),
        float(scale), build.DTYPE_CODES[q.dtype], build.stream_ptr(q.device))
    build.check(rc, "flash_attention_bwd")
    _launched(flash_attention_bwd, tensor_core, qp is not None)
    return tuple(grads)


launch_counter(flash_attention_bwd, "launches", "tc_launches",
               "pos_launches")


class FlashAttentionFunction(torch.autograd.Function):
    """``(out, lse) = f(q, k, v)``: the forward kernel with its
    log-sum-exp, and the backward kernel for the gradients, with the lse
    cotangent (when the caller uses lse) folded into delta, as the
    reference's ``_flash_bhsd_lse`` does. The optional positions select
    position mode in both and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_positions=None,
                kv_positions=None):
        if k.shape[2] != q.shape[2]:
            raise ValueError("the flash backward takes as many k/v heads as "
                             "q heads; repeat them first")
        qp, kp = _positions(q_positions, kv_positions, q.shape[1],
                            k.shape[1], q.device)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       return_lse=True, q_positions=qp,
                                       kv_positions=kp)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.positions = causal, scale, (qp, kp)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dout = dout.to(q.dtype)  # an f32 cotangent from an f32 loss tail
        qp, kp = ctx.positions
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, dlse,
                                         causal=ctx.causal, scale=ctx.scale,
                                         q_positions=qp, kv_positions=kp)
        return dq, dk, dv, None, None, None, None


def flash_attention_fused(q, k, v, causal=True, scale=None):
    """Differentiable flash attention on ``[B, S, H, D]`` (the reference's
    ``flash_attention_fused``)."""
    return FlashAttentionFunction.apply(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q, k, v, causal=True, scale=None,
                             q_positions=None, kv_positions=None):
    """``(out [B, Sq, H, D], lse [B, H, Sq] f32)``, differentiable in both:
    the lse cotangent flows back through the same backward kernel. With
    ``q_positions`` [Sq] and ``kv_positions`` [Sk] (global token indices,
    ring attention's chunks) the mask is ``q_pos >= kv_pos`` and ``causal``
    is ignored; a row that sees no key gives out 0 and lse -1e30."""
    return FlashAttentionFunction.apply(q, k, v, causal, scale, q_positions,
                                        kv_positions)
