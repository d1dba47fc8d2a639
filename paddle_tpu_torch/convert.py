"""Weights into the port: from the JAX package's parameters, or from a seed.

``state_dict_from_numpy`` takes ``{name: ndarray}`` as the JAX package
gives it (``paddle_tpu.jit.param_arrays(model)`` or ``Layer.state_dict``,
then ``np.asarray``): names and ``[in, out]`` layouts already match the
port's modules, so no renaming or transposing happens here.

``init_llama`` initialises a model directly on its device from a seed with
an explicit ``torch.Generator`` (normal, std ``initializer_range``; norm
scales are ones), so a 7B model is made on the card with no host copy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .framework.device import resolve_device, resolve_dtype
from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["state_dict_from_numpy", "init_llama", "llama_from_numpy"]


def state_dict_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    return {name: torch.from_numpy(np.array(a, np.float32, order="C",
                                            copy=True)).to(device=dev,
                                                           dtype=dt)
            for name, a in arrays.items()}


def llama_from_numpy(cfg: LlamaConfig, arrays: Dict[str, np.ndarray],
                     device=None, dtype=torch.float32) -> LlamaForCausalLM:
    """A port model holding the given parameters (every name must match)."""
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    model.load_state_dict(state_dict_from_numpy(arrays, device, dtype),
                          strict=True)
    return model.eval()


@torch.no_grad()
def init_llama(cfg: LlamaConfig, seed: int = 0, device=None,
               dtype=torch.bfloat16) -> LlamaForCausalLM:
    """A ``LlamaForCausalLM`` with random weights drawn on ``device`` from
    ``seed``: every matrix normal(0, ``initializer_range``), norm scales
    one. Parameters are drawn in ``named_parameters`` order."""
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "model.norm.weight":
            p.fill_(1.0)
        else:
            p.normal_(0.0, cfg.initializer_range, generator=gen)
    return model.eval()
