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
kernel or raises. ``quant_matmul.launches`` counts kernel launches and
``quant_matmul.tc_launches`` those on the tensor-core body
(:func:`quant_body`: bf16 x), which sums its K splits inside the launch;
f32 x keeps the FMA body and its epilogue kernel. Which row counts go to
the kernel at all is ``nn.quant``'s rule (``PALLAS_MAX_ROWS``).
:func:`quant_matmul_tc_ref` is the plain twin of the tensor-core body's
arithmetic (its split partials summed in split order), for the tests.
"""
from __future__ import annotations

import torch

from ...kernels.build import count_launch, launch_counter

__all__ = ["PALLAS_MAX_ROWS", "unpack_int4", "quant_matmul_ref",
           "quant_matmul", "quant_body", "split_plan", "tc_blocks_per_sm",
           "quant_matmul_tc_ref"]

# prefill-sized row counts are compute-bound: nn/quant.py routes rows above
# this to the dequantize-then-matmul path; the kernel serves decode rows
PALLAS_MAX_ROWS = 256

_DTYPES = (torch.float32, torch.bfloat16)
# the block tiles of csrc/quant_matmul.cu: (rows of x, columns of w)
_TILE = {"fma": (8, 128), "tensor_core": (64, 128)}
_SMS = 132                  # the H100's SMs
_FMA_TARGET_BLOCKS = 1056   # 8 FMA blocks for each SM
_MIN_K_PER_SPLIT = 256
# the tensor-core body's registers a thread for 1..8 n8 tiles of x (its
# ptxas report, which chip_smoke.py logs), and the shared memory an SM
# gives its blocks (228 KB, less 1 KB a block)
_TC_REGISTERS = (90, 101, 112, 136, 164, 186, 219, 247)
_SM_SMEM = 233472


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


def quant_body(x_dtype, rows) -> str:
    """The body the kernel runs on the card: ``"tensor_core"`` for bf16 x
    at up to ``PALLAS_MAX_ROWS`` rows (products of bf16 values, exact
    weights, f32 sums); ``"fma"`` for f32 x, whose 1e-4 checks TF32
    products would break, and for any other row count."""
    if x_dtype == torch.bfloat16 and rows <= PALLAS_MAX_ROWS:
        return "tensor_core"
    return "fma"


def _k_granule(body: str, int4: bool) -> int:
    """The k values a split must hold a multiple of: the tensor-core
    body's stage (64 weight byte rows: 64 k of int8, 128 of int4); the FMA
    body's groups of 4 k values and whole bytes of packed int4."""
    if body == "tensor_core":
        return 128 if int4 else 64
    return 8


def _cut(k: int, splits: int, gran: int):
    """(splits, k_per_split) of K cut into at most ``splits`` ranges, each
    a whole number of ``gran`` k values (the last one shorter)."""
    kps = -(-(-(-k // splits)) // gran) * gran
    return -(-k // kps), kps


def tc_blocks_per_sm(rows: int, int4: bool) -> int:
    """Blocks of the tensor-core body one SM holds at once: the fewer
    that its registers (``_TC_REGISTERS`` for the block's n8 tiles, 128
    threads) and its 4-stage shared-memory ring allow."""
    nt = -(-min(rows, 64) // 8)
    regs = -(-_TC_REGISTERS[nt - 1] // 8) * 8
    wp, xp = (160, 272) if int4 else (144, 144)
    smem = 4 * (64 * wp + nt * 8 * xp)
    return max(1, min(65536 // (regs * 128), _SM_SMEM // (smem + 1024)))


def split_plan(rows: int, k: int, n: int, int4: bool, body: str = "fma"):
    """(splits, k_per_split) of the kernel's K split, from host-known
    shapes only. The FMA body: enough blocks of (8 rows, 128 columns, K
    range) to reach ``_FMA_TARGET_BLOCKS``. The tensor-core body: as many
    splits as keep the grid within one wave of the blocks the card holds
    at once (``tc_blocks_per_sm``; a second, part-filled wave costs more
    than the split saves). Each range is at least 256 deep and a whole
    number of the body's k granules."""
    tm, tn = _TILE[body]
    gran = _k_granule(body, int4)
    tiles = -(-rows // tm) * -(-n // tn)
    if body == "tensor_core":
        want = tc_blocks_per_sm(rows, int4) * _SMS // tiles
    else:
        want = -(-_FMA_TARGET_BLOCKS // tiles)
    return _cut(k, max(1, min(want, k // _MIN_K_PER_SPLIT, 65535)), gran)


def quant_matmul_tc_ref(x, wq, scales, bias=None, weight_dtype="int8",
                        splits=None):
    """Plain twin of the tensor-core body's arithmetic: bf16 x and the
    exact weight values, each K split's partial product summed in f32, the
    partials added in split order, then scale and bias in f32 and the cast
    to x's dtype. ``splits`` defaults to ``split_plan``'s count for the
    tensor-core body; the ranges are ``split_plan``'s."""
    int4 = weight_dtype == "int4"
    w = (unpack_int4(wq) if int4 else wq).float()
    k, n = x.shape[-1], w.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).float()
    if splits is None:
        _, kps = split_plan(x2.shape[0], k, n, int4, "tensor_core")
    else:
        _, kps = _cut(k, splits, _k_granule("tensor_core", int4))
    y = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, kps):
        y = y + x2[:, k0:k0 + kps] @ w[k0:k0 + kps]
    y = y * scales.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, n)


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
    (``.launches`` counts them, ``.tc_launches`` those on the tensor-core
    body) or raises."""
    return _quant_matmul(x, wq, scales, bias, weight_dtype)


def _quant_matmul(x, wq, scales, bias=None, weight_dtype="int8", body=None,
                  splits=None):
    """``quant_matmul`` with its body (``"tensor_core"`` or ``"fma"``) and
    its K split count chosen by the caller instead of by ``quant_body`` and
    ``split_plan``: how the card tests and ``chip_smoke.py`` time the FMA
    body beside the tensor-core one on the same inputs, and the split
    counts around the plan's."""
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
    rule = quant_body(x.dtype, rows)
    body = rule if body is None else body
    if body not in ("tensor_core", "fma") or (
            body == "tensor_core" and x.dtype != torch.bfloat16):
        raise ValueError(f"quant_matmul kernel has no {body!r} body for "
                         f"{x.dtype} x")
    b = None
    if bias is not None:
        b = bias.float().contiguous()
    int4 = weight_dtype == "int4"
    if splits is None:
        splits, kps = split_plan(rows, k, n, int4, body)
    else:
        splits, kps = _cut(k, splits, _k_granule(body, int4))
    tc = body == "tensor_core"
    ws = counters = None
    if splits > 1 or not tc:
        ws = torch.empty((splits, rows, n), dtype=torch.float32,
                         device=x.device)
    if tc and splits > 1:
        tm, tn = _TILE[body]
        counters = build.arrival_counters(x.device,
                                          -(-rows // tm) * -(-n // tn))
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    lib = build.load("quant_matmul")
    rc = lib.quant_matmul(
        x2.data_ptr(), wq.data_ptr(), scales.data_ptr(),
        b.data_ptr() if b is not None else None,
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        out.data_ptr(), rows, k, n, splits, kps, build.DTYPE_CODES[x.dtype],
        int(int4), int(tc), build.stream_ptr(x.device))
    build.check(rc, "quant_matmul")
    count_launch(quant_matmul, "launches",
                 *(("tc_launches",) if tc else ()))
    return out.reshape(*lead, n)


launch_counter(quant_matmul, "launches", "tc_launches")
