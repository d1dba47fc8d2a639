"""Weight-only int8/int4 matmul: the CUDA kernel's wrapper and its plain
version.

Port of ``paddle_tpu/ops/pallas/quant_matmul.py``: ``unpack_int4``,
``PALLAS_MAX_ROWS``, ``quant_matmul_ref`` and ``quant_matmul`` (TPU kernel
``quant_matmul_pallas``). The CUDA source is
``paddle_tpu_torch/csrc/quant_matmul.cu``.

y = x . dequant(wq) * scales + bias: x ``[..., K]`` f32 or bf16; wq int8
``[K, N]`` or packed int4 ``[K // 2, N]`` (row 2k in the low nibble of byte
row k, row 2k+1 in the high nibble, the ``nn.quant.weight_quantize``
layout); scales f32 ``[N]``; bias ``[N]`` optional. The weight is cast to
x's dtype, the sum is taken in f32, scale and bias apply in f32, and the
result is cast to x's dtype.

A CPU tensor takes :func:`quant_matmul_ref`; a CUDA tensor launches the
kernel or raises. ``quant_matmul.launches`` counts kernel launches. Which
row counts go to the kernel at all is ``nn.quant``'s rule
(``PALLAS_MAX_ROWS``).
"""
from __future__ import annotations

import torch

__all__ = ["PALLAS_MAX_ROWS", "unpack_int4", "quant_matmul_ref",
           "quant_matmul", "split_plan"]

# prefill-sized row counts are compute-bound: nn/quant.py routes rows above
# this to the dequantize-then-matmul path; the kernel serves decode rows
PALLAS_MAX_ROWS = 256

_DTYPES = (torch.float32, torch.bfloat16)
_ROWS, _COLS = 8, 128      # the kernel's block tile (csrc/quant_matmul.cu)
_TARGET_BLOCKS = 1056      # 8 blocks for each of the H100's 132 SMs
_MIN_K_PER_SPLIT = 256


def unpack_int4(packed):
    """``[K // 2, N]`` packed nibbles → ``[K, N]`` int8 (row 2k = low nibble
    of byte k, row 2k+1 = high nibble), sign-extended by a shift pair."""
    w = packed.to(torch.int32)
    lo = (w << 28) >> 28
    hi = w >> 4
    k2, n = w.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def quant_matmul_ref(x, wq, scales, bias=None, weight_dtype="int8"):
    """Plain twin of the kernel, with its dtype discipline: weight cast to
    x's dtype, f32 sum, scale and bias in f32, cast to x's dtype."""
    w = unpack_int4(wq) if weight_dtype == "int4" else wq
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    y = y * scales.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def split_plan(rows: int, k: int, n: int, int4: bool):
    """(splits, k_per_split) of the kernel's K split: enough blocks of
    (8 rows, 128 columns, K range) to fill the card, each range at least
    256 deep and a multiple of 8 (whole groups of 4 k values, and whole
    bytes of packed int4)."""
    tiles = -(-rows // _ROWS) * -(-n // _COLS)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles),
                        k // _MIN_K_PER_SPLIT, 65535))
    kps = -(-(-(-k // splits)) // 8) * 8
    return -(-k // kps), kps


def _check(x, wq, scales, bias, weight_dtype):
    if weight_dtype not in ("int8", "int4"):
        raise NotImplementedError(f"quant_matmul: {weight_dtype!r}")
    if wq.dim() != 2 or wq.dtype != torch.int8:
        raise TypeError("quant_matmul: wq must be a 2-D int8 tensor")
    k = x.shape[-1]
    if weight_dtype == "int4":
        if k % 2:
            raise ValueError(f"int4 needs even K (got {k})")
        if wq.shape[0] * 2 != k:
            raise ValueError(
                f"packed int4 weight rows {wq.shape[0]} != K/2 = {k // 2}")
    elif wq.shape[0] != k:
        raise ValueError(f"weight rows {wq.shape[0]} != K = {k}")
    n = wq.shape[1]
    if tuple(scales.shape) != (n,):
        raise ValueError(f"scales must be [{n}], got {tuple(scales.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    tensors = [x, wq, scales] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must live on one device")


def quant_matmul(x, wq, scales, bias=None, weight_dtype="int8"):
    """y = x . dequant(wq) * scales + bias in x's dtype, ``[..., N]``. A CPU
    tensor takes the plain twin; a CUDA tensor launches the kernel
    (``.launches`` counts them) or raises."""
    _check(x, wq, scales, bias, weight_dtype)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, wq, scales, bias, weight_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from ...kernels import build

    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_matmul kernel takes f32 or bf16 x, got "
                        f"{x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError("quant_matmul kernel takes f32 scales")
    k, n = x.shape[-1], wq.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    rows = x2.shape[0]
    if rows == 0:
        return x.new_empty((*lead, n))
    if not (x2.is_contiguous() and wq.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("quant_matmul kernel operands must be contiguous")
    b = None
    if bias is not None:
        b = bias.float().contiguous()
    int4 = weight_dtype == "int4"
    splits, kps = split_plan(rows, k, n, int4)
    ws = torch.empty((splits, rows, n), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    lib = build.load("quant_matmul")
    rc = lib.quant_matmul(
        x2.data_ptr(), wq.data_ptr(), scales.data_ptr(),
        b.data_ptr() if b is not None else None, ws.data_ptr(),
        out.data_ptr(), rows, k, n, splits, kps, build.DTYPE_CODES[x.dtype],
        int(int4), build.stream_ptr(x.device))
    build.check(rc, "quant_matmul")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0
