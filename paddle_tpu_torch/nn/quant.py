"""Weight-only quantization for the decode path, after
``paddle_tpu/nn/quant.py``.

Weights are stored int8 (or two int4 nibbles a byte) with one f32 scale per
output channel (symmetric): small-batch decode reads every weight byte once
a step, so int8 halves and int4 quarters the dominant device-memory
traffic.

Routing (``quant_backend``) follows ``FLAGS_weight_only_quant_backend``.
Under ``"auto"`` (the default, the reference's rule) a CUDA tensor with at
most ``PALLAS_MAX_ROWS`` (256) rows takes the fused kernel #12
(``ops/cuda/quant_matmul.py``, dequant inside the kernel); more rows
(prefill) and the CPU take :func:`quant_matmul_xla`, which dequantizes and
hands the product to ``torch.matmul``. ``"cuda"`` (or the reference's
``"pallas"``) forces the kernel's wrapper, which takes its plain version
for a CPU tensor; ``"xla"`` forces :func:`quant_matmul_xla`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.flags import get_flags
from ..ops.cuda.quant_matmul import PALLAS_MAX_ROWS, quant_matmul
from .common import Linear

__all__ = ["weight_quantize", "weight_only_linear", "WeightOnlyLinear",
           "quantize_for_decode", "quant_backend", "quant_matmul_xla"]


def quant_backend(rows=None, device=None) -> str:
    """``"cuda"`` (kernel #12) or ``"xla"`` (dequantize, then
    ``torch.matmul``), by ``FLAGS_weight_only_quant_backend``; under
    ``"auto"``: ``"cuda"`` for a CUDA device at ``rows`` <= 256 (or rows
    unknown), else ``"xla"``."""
    val = get_flags("FLAGS_weight_only_quant_backend")[
        "FLAGS_weight_only_quant_backend"]
    if val not in ("auto", "cuda", "pallas", "xla"):
        raise ValueError(
            f"FLAGS_weight_only_quant_backend: {val!r} not in "
            "('auto', 'cuda', 'pallas', 'xla')")
    if val != "auto":
        return "xla" if val == "xla" else "cuda"
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "xla"
    if rows is not None and rows > PALLAS_MAX_ROWS:
        return "xla"
    return "cuda"


def weight_quantize(x, algo="weight_only_int8"):
    """Per-output-channel symmetric quantization of an ``[in, out]`` weight.

    * ``weight_only_int8`` → (int8 weight ``[in, out]``, f32 scales
      ``[out]``), scale = max|w| / 127.
    * ``weight_only_int4`` → (int8 weight ``[in / 2, out]``, f32 scales
      ``[out]``), scale = max|w| / 7, values in [-7, 7], row 2k in the low
      nibble of byte row k and row 2k+1 in the high nibble.
    """
    w = x.detach().float()
    amax = torch.amax(torch.abs(w), dim=0)
    if algo == "weight_only_int8":
        scales = torch.clamp_min(amax, 1e-8) / 127.0
        q = torch.clamp(torch.round(w / scales[None, :]), -127, 127)
        return q.to(torch.int8), scales
    if algo == "weight_only_int4":
        if w.shape[0] % 2:
            raise ValueError("weight_only_int4 needs even in_features "
                             f"(got {w.shape[0]})")
        scales = torch.clamp_min(amax, 1e-8) / 7.0
        q = torch.clamp(torch.round(w / scales[None, :]), -7, 7).to(
            torch.int32)
        packed = (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)
        return packed.to(torch.uint8).view(torch.int8), scales
    raise NotImplementedError(f"weight_quantize: unsupported algo {algo!r}")


def quant_matmul_xla(xa, wq, sc, bias=None, weight_dtype="int8"):
    """The reference's XLA backend: int4 as two products over the nibble
    halves (even input columns against the low nibbles, odd against the
    high), int8 as one; the weight in x's dtype, the sum in f32, the scale
    in f32, then the cast to x's dtype BEFORE the bias is added. A bf16 x
    sums in f32 inside ``torch.matmul`` and rounds its product to bf16
    before the scale."""
    if weight_dtype == "int4":
        w = wq.to(torch.int32)
        lo = ((w << 28) >> 28).to(xa.dtype)
        hi = (w >> 4).to(xa.dtype)
        y = (torch.matmul(xa[..., 0::2], lo).float()
             + torch.matmul(xa[..., 1::2], hi).float())
    else:
        y = torch.matmul(xa, wq.to(xa.dtype)).float()
    y = (y * sc.float()).to(xa.dtype)
    if bias is not None:
        y = y + bias.to(xa.dtype)
    return y


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8"):
    """y = x . dequant(W) + b with int8- or int4-stored W, routed by
    :func:`quant_backend` on x's rows and device."""
    if weight_dtype not in ("int8", "int4"):
        raise NotImplementedError("weight_only_linear: int8/int4 only")
    rows = 1
    for d in x.shape[:-1]:
        rows *= int(d)
    if quant_backend(rows, x.device) == "cuda":
        return quant_matmul(x, weight, weight_scale, bias=bias,
                            weight_dtype=weight_dtype)
    return quant_matmul_xla(x, weight, weight_scale, bias=bias,
                            weight_dtype=weight_dtype)


class WeightOnlyLinear(nn.Module):
    """Serving replacement for ``Linear`` with an int8 or packed-int4
    weight. The quantized weight and its scales are buffers, not
    parameters: a quantized model serves, it does not train."""

    def __init__(self, linear, algo="weight_only_int8"):
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.weight_dtype = "int4" if algo == "weight_only_int4" else "int8"
        qw, scales = weight_quantize(linear.weight, algo=algo)
        self.register_buffer("weight", qw)
        self.register_buffer("weight_scale", scales)
        bias = getattr(linear, "bias", None)
        if bias is not None:
            self.register_buffer("bias", bias.detach().clone())
        else:
            self.bias = None

    def forward(self, x):
        return weight_only_linear(x, self.weight, self.bias,
                                  self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, {self.weight_dtype}")


@torch.no_grad()
def quantize_for_decode(model, include=None, min_features=0,
                        algo="weight_only_int8"):
    """Swap eligible ``Linear`` submodules for ``WeightOnlyLinear``, in
    place. ``include``: optional predicate ``(qualified_name, module) ->
    bool``; by default every Linear with ``in_features >= min_features`` is
    quantized. ``weight_only_int4`` skips odd ``in_features``, which cannot
    nibble-pack. Returns ``(model, number swapped)``."""
    swapped = 0
    for name, sub in list(model.named_modules()):
        for child_name, child in list(sub.named_children()):
            if not isinstance(child, Linear):
                continue
            qual = f"{name}.{child_name}" if name else child_name
            if child.in_features < min_features:
                continue
            if algo == "weight_only_int4" and child.in_features % 2:
                continue
            if include is not None and not include(qual, child):
                continue
            setattr(sub, child_name, WeightOnlyLinear(child, algo=algo))
            swapped += 1
    return model, swapped
