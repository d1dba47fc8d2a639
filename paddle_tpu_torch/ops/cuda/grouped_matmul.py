"""Ragged grouped matmul over stacked expert weights: the CUDA kernel's
wrapper and its plain version.

Port of ``paddle_tpu/ops/pallas/grouped_matmul.py``:
``aligned_segment_offsets``, ``grouped_matmul_ref`` and ``grouped_matmul``
(TPU kernel ``grouped_matmul_pallas``). The CUDA source is
``paddle_tpu_torch/csrc/grouped_matmul.cu``.

Semantics are ``jax.lax.ragged_dot(lhs, rhs, group_sizes)`` with two
additions: rows past ``sum(group_sizes)`` and rows past an expert's
``valid_sizes[e]`` come back exactly zero. ``lhs [M, K]`` holds expert
e's rows as the contiguous segment of ``group_sizes[e]`` rows; ``rhs [E,
K, N]``; sums in f32, result in lhs's dtype.

A CPU tensor takes :func:`grouped_matmul_ref`; a CUDA tensor launches the
kernel or raises. ``grouped_matmul.launches`` counts kernel launches. The
kernel reads the group sizes on the card, so a call never waits for the
device.

The kernel has two bodies, chosen from host-known shapes
(``grouped_body``): bf16 calls with at least 64 capacity rows an expert
(prefill waves) and K, N multiples of 8 run on ``wgmma`` fed by TMA
(``grouped_matmul.wgmma_launches`` counts them, included in
``.launches``); every other call (decode, f32) on the WMMA body. TMA needs
16-byte aligned bases, so the ``wgmma`` body refuses a misaligned ``lhs``
or ``rhs`` with a ``ValueError`` naming it; it never reroutes the call.
"""
from __future__ import annotations

import torch

from ...kernels.build import count_launch, launch_counter

__all__ = ["aligned_segment_offsets", "grouped_matmul_ref",
           "grouped_matmul", "grouped_body", "check_wgmma_alignment"]

_DTYPES = (torch.float32, torch.bfloat16)
# the JAX package pads each group to one f32 sublane tile of rows; the CUDA
# kernel pads each group on the card to its own row tile (64 rows on the
# WMMA body, 128 on the wgmma body)
_GROUP_TILE = 8
_WGMMA_MIN_ROWS = 64  # capacity rows an expert from which wgmma pays
_BODY_CODES = {"wmma": 0, "wgmma": 1}  # the C entry's body argument


def grouped_body(dtype, m, k, n, num_experts) -> str:
    """The body the grouped matmul kernel runs for lhs ``[m, k]`` and rhs
    ``[num_experts, k, n]``, from host-known shapes only: ``"wgmma"`` for
    bf16 with ``m / num_experts >= 64`` capacity rows an expert and k, n
    multiples of 8 (TMA's 16-byte global strides); ``"wmma"`` for every
    other call, decode (a few rows an expert, bound by the weight bytes)
    and f32 (held to 1e-4, which bf16 products would break)."""
    if (dtype == torch.bfloat16 and m >= _WGMMA_MIN_ROWS * num_experts
            and k % 8 == 0 and n % 8 == 0):
        return "wgmma"
    return "wmma"


def check_wgmma_alignment(*named):
    """Refuse an operand the wgmma body's TMA loads cannot read: each
    ``(name, tensor)``'s base address must be a multiple of 16 bytes.
    Raises ``ValueError`` naming the operand."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the wgmma grouped matmul needs a "
                             f"16-byte aligned base address, got "
                             f"{t.data_ptr():#x}")


def aligned_segment_offsets(group_sizes, tile: int = _GROUP_TILE):
    """(aligned_sizes, aligned_offsets) with every group's segment padded up
    to ``tile`` rows."""
    sizes = torch.clamp(torch.as_tensor(group_sizes, dtype=torch.int32),
                        min=0)
    aligned = (sizes + tile - 1) // tile * tile
    return aligned, torch.cumsum(aligned, 0, dtype=torch.int32) - aligned


def _row_keep(sizes, vsz, m):
    """[m] bool: row p lies in a group and below that group's valid
    count (the reference's ``searchsorted`` rule)."""
    e = sizes.shape[0]
    ends = torch.cumsum(sizes.long(), 0)
    p = torch.arange(m, device=sizes.device)
    gp = torch.searchsorted(ends, p, right=True)
    gpc = torch.clamp(gp, max=e - 1)
    lp = p - (ends - sizes.long())[gpc]
    return (gp < e) & (lp < vsz.long()[gpc])


def grouped_matmul_ref(lhs, rhs, group_sizes, valid_sizes=None):
    """Plain twin: one f32 matmul per group, cast to lhs's dtype, zero on
    rows past the groups and past ``valid_sizes``. Reads the group sizes
    on the host."""
    sizes = torch.clamp(torch.as_tensor(group_sizes, device=lhs.device)
                        .to(torch.int32), min=0)
    vsz = sizes if valid_sizes is None else torch.minimum(
        sizes, torch.as_tensor(valid_sizes, device=lhs.device)
        .to(torch.int32))
    m = lhs.shape[0]
    y = torch.zeros((m, rhs.shape[2]), dtype=torch.float32,
                    device=lhs.device)
    start = 0
    for e, s in enumerate(sizes.tolist()):
        stop = min(start + s, m)
        if stop > start:
            y[start:stop] = torch.matmul(lhs[start:stop].float(),
                                         rhs[e].float())
        start = stop
    keep = _row_keep(sizes, vsz, m)
    return torch.where(keep[:, None], y.to(lhs.dtype),
                       torch.zeros((), dtype=lhs.dtype, device=lhs.device))


def grouped_matmul(lhs, rhs, group_sizes, valid_sizes=None):
    """``ragged_dot`` with zeroed tails. A CPU tensor takes the plain twin;
    a CUDA tensor launches the kernel (``.launches`` counts them,
    ``.wgmma_launches`` those on the wgmma body) or raises. On the card
    ``group_sizes`` and ``valid_sizes`` must be int32 tensors there."""
    return _grouped(lhs, rhs, group_sizes, valid_sizes)


def _grouped(lhs, rhs, group_sizes, valid_sizes=None, body=None):
    """``grouped_matmul`` on the body the caller names (``"wgmma"`` or
    ``"wmma"``) instead of ``grouped_body``'s: how ``chip_smoke.py`` times
    the WMMA body beside the wgmma one."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError("grouped_matmul takes lhs [M, K] and rhs [E, K, N]")
    m, k = lhs.shape
    e, k2, n = rhs.shape
    if k2 != k:
        raise ValueError(f"rhs K {k2} != lhs K {k}")
    if tuple(torch.as_tensor(group_sizes).shape) != (e,):
        raise ValueError(f"group_sizes must be [{e}]")
    if valid_sizes is not None and \
            tuple(torch.as_tensor(valid_sizes).shape) != (e,):
        raise ValueError(f"valid_sizes must be [{e}]")
    if lhs.device.type == "cpu":
        return grouped_matmul_ref(lhs, rhs, group_sizes, valid_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    from ...kernels import build

    if lhs.dtype not in _DTYPES or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul kernel takes f32 or bf16 lhs and rhs "
                        f"of one dtype, got {lhs.dtype} and {rhs.dtype}")
    sizes = [group_sizes] + ([valid_sizes] if valid_sizes is not None
                             else [])
    if not all(isinstance(t, torch.Tensor) and t.dtype == torch.int32
               and t.device == lhs.device for t in sizes):
        raise TypeError("group_sizes and valid_sizes must be int32 tensors "
                        "on lhs's device")
    if rhs.device != lhs.device:
        raise ValueError("all operands must live on one device")
    if not (lhs.is_contiguous() and rhs.is_contiguous()
            and all(t.is_contiguous() for t in sizes)):
        raise ValueError("grouped_matmul kernel operands must be contiguous")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    rule = grouped_body(lhs.dtype, m, k, n, e)
    body = rule if body is None else body
    code = _BODY_CODES.get(body)
    if code is None or (code and not (lhs.dtype == torch.bfloat16
                                      and k % 8 == 0 and n % 8 == 0)):
        raise ValueError(f"grouped_matmul kernel has no {body!r} body for "
                         f"{lhs.dtype} [{m}, {k}] x [{e}, {k}, {n}]")
    if code:
        check_wgmma_alignment(("lhs", lhs), ("rhs", rhs))
    lib = build.load("grouped_matmul")
    rc = lib.grouped_matmul(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
        valid_sizes.data_ptr() if valid_sizes is not None else None,
        out.data_ptr(), m, k, n, e, build.DTYPE_CODES[lhs.dtype], code,
        build.stream_ptr(lhs.device))
    build.check(rc, "grouped_matmul")
    count_launch(grouped_matmul, "launches",
                 *(("wgmma_launches",) if code else ()))
    return out


launch_counter(grouped_matmul, "launches", "wgmma_launches")
