"""The port's inference runtime surface (``inference.Config``,
``Tensor``, ``Predictor``, ``create_predictor``) against paddle_tpu's,
and the port's import boundary.

* A program ``jit.save``-d by each package from the same weights, run by
  each package's Predictor: the outputs agree within 2e-5 (the port's
  flash twin against the reference's naive attention, f32), directly
  (``run([numpy]) -> [numpy]``) and through the handles, at two batch
  sizes of the port's ``None`` dim (the reference's export refuses a
  ``None`` dim for this model, so it saves one program a batch size).
* ``Config``: the prefix with a ``.pt2`` or ``.pdmodel`` suffix stripped,
  ``set_model``, ``disable_gpu`` (the CPU) / ``enable_use_gpu`` (the card
  by id), the no-op knobs, TensorRT refused; the Predictor's refusals.
* No module of ``paddle_tpu_torch`` (nor ``chip_smoke.py``) imports jax or
  paddle_tpu: every module is imported in a fresh interpreter.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit

import paddle_tpu_torch
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import state_dict_from_numpy
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
D, H, V, S = 32, 4, 40, 8


class JaxNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(V, D)
        self.encoder = jnn.TransformerEncoder(
            jnn.TransformerEncoderLayer(D, H, 2 * D, dropout=0.0), 1)
        self.head = jnn.Linear(D, V)

    def forward(self, ids):
        return self.head(self.encoder(self.emb(ids)))


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, D, device="cpu")
        self.encoder = nn.TransformerEncoder(
            nn.TransformerEncoderLayer(D, H, 2 * D, dropout=0.0,
                                       device="cpu"), 1)
        self.head = nn.Linear(D, V, device="cpu")

    def forward(self, ids):
        return self.head(self.encoder(self.emb(ids)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both packages' programs of one set of weights: ``(the port's prefix
    with a None batch dim, {batch: the reference's prefix})``."""
    d = tmp_path_factory.mktemp("predictor")
    jm = JaxNet()
    r = np.random.default_rng(0)
    for _, p in jm.named_parameters():
        p.set_value(jnp.asarray(0.2 * r.standard_normal(tuple(p.shape)),
                                jnp.float32))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jjit.param_arrays(jm).items()}
    tm = Net()
    tm.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                       strict=True)
    tm.eval()
    port = str(d / "port")
    jit.save(tm, port, input_spec=[jit.InputSpec([None, S], "int32")])
    refs = {}
    for b in (1, 3):  # the reference's export takes no None dim here
        refs[b] = str(d / f"ref{b}")
        jjit.save(jm, refs[b], input_spec=[jjit.InputSpec([b, S],
                                                          "int32")])
    return port, refs


def _cpu_config(path):
    cfg = inference.Config(path)
    cfg.disable_gpu()
    return cfg


@pytest.mark.parametrize("batch", [1, 3])
def test_predictor_run_matches_the_reference(saved, batch):
    port, refs = saved
    ids = np.random.default_rng(batch).integers(0, V, (batch, S)).astype(
        np.int32)
    want = jinf.create_predictor(jinf.Config(refs[batch])).run([ids])[0]
    pred = inference.create_predictor(_cpu_config(port + ".pt2"))
    assert pred.get_input_names() == ["x0"]
    got = pred.run([ids])
    assert len(got) == 1 and isinstance(got[0], np.ndarray)
    np.testing.assert_allclose(got[0], want, rtol=2e-5, atol=2e-5)
    # the reference's handle-based flow
    h = pred.get_input_handle("x0")
    h.copy_from_cpu(ids)
    assert h.shape() == [batch, S]
    assert pred.run() is None
    assert pred.get_output_names() == ["out0"]
    out = pred.get_output_handle("out0")
    np.testing.assert_array_equal(out.copy_to_cpu(), got[0])
    out.reshape([batch * S, V])
    assert out.shape() == [batch * S, V]


def test_predictor_refusals(saved):
    port, _ = saved
    pred = inference.Predictor(_cpu_config(port))
    with pytest.raises(RuntimeError):
        pred.run()  # x0 was never set
    with pytest.raises(ValueError):
        pred.run([np.zeros((1, S), np.int32)] * 2)
    with pytest.raises(KeyError):
        pred.get_output_handle("out7")
    with pytest.raises(RuntimeError):
        inference.Tensor("y").copy_to_cpu()
    with pytest.raises(ValueError):
        inference.Predictor(inference.Config())


def test_config_surface():
    cfg = inference.Config("/a/b/model.pdmodel", "/a/b/model.pdiparams")
    assert cfg.model_dir() == cfg.prog_file() == "/a/b/model"
    cfg.set_model("/c/d.pt2")
    assert cfg.prog_file() == "/c/d"
    assert cfg.device() == "cuda:0"
    cfg.enable_use_gpu(256, device_id=1)
    assert cfg.device() == "cuda:1"
    cfg.disable_gpu()
    assert cfg.device() == "cpu"
    cfg.enable_memory_optim()
    cfg.switch_ir_optim(False)
    with pytest.raises(NotImplementedError):
        cfg.enable_tensorrt_engine()
    ref = jinf.Config("/a/b/model.pdmodel")
    assert ref.prog_file() == inference.Config(
        "/a/b/model.pdmodel").prog_file()


def test_no_module_imports_jax_or_the_reference():
    """Every module of the port (the launcher, store, rpc and parameter
    server included), ``chip_smoke.py`` and the example twins added with
    configs 2, 4 and 5 import in a fresh interpreter with neither jax nor
    paddle_tpu loaded."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch."))
    assert "paddle_tpu_torch.jit" in mods
    assert "paddle_tpu_torch.distributed.fleet.recompute" in mods
    for m in ("distributed.launch.main", "distributed.launch.master",
              "distributed.launch.controllers", "distributed.launch.__main__",
              "distributed.spawn", "distributed.store", "distributed.rpc",
              "distributed.ps", "native"):
        assert f"paddle_tpu_torch.{m}" in mods, m
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "for name in ('train_bert_torch', 'to_static_export_torch',\n"
            "             'pretrain_gpt_hybrid_torch'):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, f'examples/{name}.py')\n"
            "    spec.loader.exec_module(\n"
            "        importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
