"""Main-grad mixed precision (after
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py``).

``MixPrecisionLayer`` casts the floating parameters to ``dtype`` (bf16 by
default) and hooks each one so that every backward adds its gradient, in
f32, to the parameter's ``main_grad`` and leaves the low-precision
gradient zero. ``MixPrecisionOptimizer`` steps the wrapped optimizer on
``main_grad`` (against its f32 master weights, ``multi_precision``) and
clears both gradients in ``clear_grad``.
"""
from __future__ import annotations

import torch

from ....framework.device import resolve_dtype

__all__ = ["MixPrecisionLayer", "MixPrecisionOptimizer"]


class MixPrecisionLayer(torch.nn.Module):
    def __init__(self, layers, dtype: str = "bfloat16"):
        super().__init__()
        self._layers = layers
        target = resolve_dtype(dtype)
        for p in layers.parameters():
            if not p.is_floating_point():
                continue
            p.data = p.data.to(target)
            p.main_grad = None

            def hook(grad, p=p):
                g32 = grad.detach().float()
                p.main_grad = g32 if p.main_grad is None else \
                    p.main_grad + g32
                return torch.zeros_like(grad)

            p.register_hook(hook)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__") or name == "_layers":
                raise
            return getattr(self._modules["_layers"], name)


class MixPrecisionOptimizer:
    def __init__(self, optimizer):
        self._inner_opt = optimizer

    def step(self):
        named = self._inner_opt._named_parameter_list()
        self._inner_opt._step_with([
            p.main_grad if getattr(p, "main_grad", None) is not None
            else p.grad for _, p in named])

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._inner_opt._parameter_list():
            if getattr(p, "main_grad", None) is not None:
                p.main_grad = None
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)
