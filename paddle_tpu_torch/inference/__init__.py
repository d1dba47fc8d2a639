"""Serving stack of the port (after ``paddle_tpu.inference``), and the
reference's inference runtime surface: ``Config``, ``Tensor``,
``Predictor`` and ``create_predictor``.

A ``Predictor`` runs a program that ``jit.save`` wrote (``<prefix>.pt2``
and ``<prefix>.pdiparams``), loaded by ``jit.load`` onto the card (or the
CPU after ``Config.disable_gpu()``), with the reference's handle-based API
(``get_input_names`` / ``get_input_handle`` / ``copy_from_cpu`` / ``run``
/ ``get_output_handle`` / ``copy_to_cpu``) or directly, ``run([numpy
arrays]) -> [numpy arrays]``. Inputs are named ``x0``, ``x1``, ... in the
order of the saved program's ``input_spec``. The reference's tuning knobs
(memory pool, IR passes) have nothing to tune here and are kept as
no-ops; TensorRT raises, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Config", "Predictor", "Tensor", "create_predictor"]

_SUFFIXES = (".pt2", ".pdmodel")


class Config:
    """The ``jit.save`` prefix of a program (``Config(prog_file,
    params_file)`` is also taken: a ``.pt2`` or ``.pdmodel`` suffix is
    stripped from ``prog_file``)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        for suffix in _SUFFIXES:
            if prog_file and prog_file.endswith(suffix):
                prog_file = prog_file[:-len(suffix)]
        self._prefix = prog_file
        self._device = "cuda"
        self._device_id = 0

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self.__init__(prog_file, params_file)

    def model_dir(self):
        return self._prefix

    def prog_file(self):
        return self._prefix

    def device(self) -> str:
        """Where the predictor runs: ``"cuda:<id>"`` or ``"cpu"``."""
        if self._device == "cpu":
            return "cpu"
        return f"cuda:{self._device_id}"

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "cuda", device_id

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self):
        pass

    def switch_ir_optim(self, x: bool = True):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "TensorRT is not part of the port: the saved program runs the "
            "port's own kernels")


class Tensor:
    """An input or output handle (the reference's ``paddle_infer.Tensor``)
    holding a tensor on the predictor's device."""

    def __init__(self, name: str, device=None):
        self.name = name
        self._device = device
        self._value: Optional[torch.Tensor] = None

    def copy_from_cpu(self, arr):
        self._value = torch.as_tensor(np.asarray(arr)).to(self._device)

    def copy_to_cpu(self):
        if self._value is None:
            raise RuntimeError(f"output {self.name!r} not populated; run()?")
        return self._value.detach().cpu().numpy()

    def shape(self):
        return list(self._value.shape) if self._value is not None else None

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)


class Predictor:
    """Runs a ``jit.save``-d program (the reference's
    ``AnalysisPredictor``)."""

    def __init__(self, config: Config):
        from ..framework.device import resolve_device
        from ..jit import load as jit_load

        if not config._prefix:
            raise ValueError("Config has no model path")
        self._device = resolve_device(config.device())
        self._translated = jit_load(config._prefix, device=self._device)
        n_in = self._translated.num_inputs
        self._input_names = [f"x{i}" for i in range(n_in)]
        self._inputs: Dict[str, Tensor] = {
            n: Tensor(n, self._device) for n in self._input_names}
        self._outputs: List[Tensor] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def run(self, inputs: Optional[Sequence] = None):
        """Handle-based (``run()`` after ``copy_from_cpu``; returns None)
        or direct: ``run([numpy arrays]) -> [numpy arrays]``."""
        if inputs is not None:
            if len(inputs) != len(self._input_names):
                raise ValueError(f"the program takes "
                                 f"{len(self._input_names)} inputs, got "
                                 f"{len(inputs)}")
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        args = []
        for n in self._input_names:
            h = self._inputs[n]
            if h._value is None:
                raise RuntimeError(f"input {n!r} not set")
            args.append(h._value)
        out = self._translated(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = []
        for i, o in enumerate(outs):
            t = Tensor(f"out{i}", self._device)
            t._value = o
            self._outputs.append(t)
        if inputs is not None:
            return [t.copy_to_cpu() for t in self._outputs]
        return None

    def get_output_names(self) -> List[str]:
        return [t.name for t in self._outputs] or ["out0"]

    def get_output_handle(self, name: str) -> Tensor:
        for t in self._outputs:
            if t.name == name:
                return t
        raise KeyError(name)


def create_predictor(config: Config) -> Predictor:
    """The reference's ``paddle_infer.create_predictor``."""
    return Predictor(config)
