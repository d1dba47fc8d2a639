"""The port's initializers, ``ParamAttr`` and ``Layer`` surface against
paddle_tpu's.

* ``_fans`` and ``calculate_gain``: equal to the reference's, exactly.
* Each random initializer at ``[512, 1024]`` (2^19 draws) and at a conv
  shape: its sample mean within 0.02 standard deviations of the reference
  sample's mean, its standard deviation within 2% of the reference
  sample's. Two independent samples of 2^19 differ by
  about 0.2% in std and 0.002 std in mean (1.4 / sqrt(n)), so the bounds
  sit ten standard errors out. The draws come from the generator given,
  the same seed gives the same bits, and torch's global generator is
  never read.
* ``Constant`` and ``Assign``: exact, in every dtype they are given.
* A ``ParamAttr`` (or a bare initializer) overrides a layer's default;
  ``trainable=False`` turns the gradient off.
* Fresh layers: ``Linear(512, 512)`` finite with std within 5% of
  ``sqrt(2 / 1024)`` and a zero bias; ``Embedding`` std within 5% of 1;
  ``FusedMultiTransformer`` and LLaMA's MoE experts within 5% of the same
  parameters of the reference's fresh layers, biases zero and LN scales
  one. (Uninitialised ``torch.empty`` memory fails these.)
* ``LayerList`` / ``ParameterList`` / ``create_parameter`` names equal the
  reference's, and a reference state dict loads into the port by name
  (values exact).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework.param_attr import ParamAttr as JParamAttr
from paddle_tpu.incubate.nn import FusedMultiTransformer as JFMT
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import initializer as jinit

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.framework.param_attr import ParamAttr
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer as TFMT
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import initializer as tinit
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(), (5,), (3, 4), (8, 4, 3, 3), (6, 2, 5), (2, 3, 4, 5, 6)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fans_equal_reference(shape):
    assert tinit._fans(shape) == jinit._fans(shape)


@pytest.mark.parametrize("nl,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2),
    ("selu", None), ("gelu", None)])
def test_calculate_gain_equals_reference(nl, param):
    assert tinit.calculate_gain(nl, param) == jinit.calculate_gain(nl, param)


RANDOM = {
    "Normal": lambda m: m.Normal(0.5, 2.0),
    "TruncatedNormal": lambda m: m.TruncatedNormal(0.1, 3.0),
    "TruncatedNormal narrow": lambda m: m.TruncatedNormal(0.0, 1.0,
                                                          -1.0, 0.5),
    "Uniform": lambda m: m.Uniform(-1.0, 3.0),
    "XavierNormal": lambda m: m.XavierNormal(),
    "XavierNormal gain": lambda m: m.XavierNormal(gain=2.0),
    "XavierUniform": lambda m: m.XavierUniform(),
    "KaimingNormal": lambda m: m.KaimingNormal(),
    "KaimingNormal leaky": lambda m: m.KaimingNormal(
        negative_slope=0.2, nonlinearity="leaky_relu"),
    "KaimingUniform": lambda m: m.KaimingUniform(),
    "KaimingUniform fan_in": lambda m: m.KaimingUniform(fan_in=50),
}


@pytest.mark.parametrize("shape", [(512, 1024), (256, 128, 4, 4)])
@pytest.mark.parametrize("name", list(RANDOM))
def test_random_initializer_matches_reference_distribution(name, shape):
    ref = np.asarray(RANDOM[name](jinit)(shape, jnp.float32,
                                         jax.random.PRNGKey(3)))
    t = torch.empty(shape)
    before = torch.random.get_rng_state()
    RANDOM[name](tinit)(t, torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), before)
    got = t.numpy()
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) <= 0.02 * ref.std()
    assert abs(got.std() / ref.std() - 1) <= 0.02
    if name.startswith("TruncatedNormal"):
        init = RANDOM[name](tinit)
        lo, hi = (init.mean + init.std * init.a, init.mean + init.std * init.b)
        assert got.min() >= lo - 1e-5 and got.max() <= hi + 1e-5


def test_draws_follow_the_generator_and_the_global_stream():
    """The same seed gives the same bits; without a generator each
    initializer call takes the next ``framework.random`` generator (one
    step of the stream a random parameter), so ``seed`` replays it."""
    a, b = torch.empty(64, 32), torch.empty(64, 32)
    tinit.XavierUniform()(a, torch.Generator().manual_seed(9))
    tinit.XavierUniform()(b, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    prandom.seed(11)
    l1 = tnn.Linear(16, 8, device="cpu")
    e1 = tnn.Embedding(10, 4, device="cpu")
    assert prandom.get_rng_state()["counter"] == 2
    prandom.seed(11)
    l2 = tnn.Linear(16, 8, device="cpu")
    e2 = tnn.Embedding(10, 4, device="cpu")
    assert torch.equal(l1.weight, l2.weight)
    assert torch.equal(e1.weight, e2.weight)
    assert not torch.equal(l1.weight[:4, :4], e1.weight[:4, :4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_constant_and_assign_are_exact(dtype):
    t = torch.empty((3, 5), dtype=dtype)
    tinit.Constant(0.375)(t)
    assert torch.equal(t, torch.full((3, 5), 0.375, dtype=dtype))
    src = np.arange(15, dtype=np.float32).reshape(3, 5) / 8
    tinit.Assign(src)(t)
    assert torch.equal(t.float(), torch.from_numpy(src))
    ref = np.asarray(jinit.Assign(src)((3, 5), jnp.float32, None))
    np.testing.assert_array_equal(t.float().numpy(), ref)
    with pytest.raises(ValueError):
        tinit.Assign(np.zeros((2, 2)))(t)


@pytest.mark.parametrize("attr", [None, False, "w0", "initializer"])
def test_param_attr_to_attr_equals_reference(attr):
    if attr == "initializer":
        got = ParamAttr._to_attr(tinit.Constant(1.0))
        want = JParamAttr._to_attr(jinit.Constant(1.0))
    else:
        got, want = ParamAttr._to_attr(attr), JParamAttr._to_attr(attr)
    assert type(got).__name__ == type(want).__name__
    if want not in (None, False):
        for f in ("name", "learning_rate", "trainable", "need_clip"):
            assert getattr(got, f) == getattr(want, f)
        assert (got.initializer is None) == (want.initializer is None)


def test_param_attr_overrides_the_default():
    lin = tnn.Linear(4, 3, weight_attr=ParamAttr(
        initializer=tinit.Constant(0.5)), bias_attr=ParamAttr(
        initializer=tinit.Constant(-1.0), name="b"), device="cpu")
    assert torch.equal(lin.weight, torch.full((4, 3), 0.5))
    assert torch.equal(lin.bias, torch.full((3,), -1.0))
    assert lin.bias.param_attr.name == "b"
    lin = tnn.Linear(4, 3, weight_attr=tinit.Constant(2.0), device="cpu")
    assert torch.equal(lin.weight, torch.full((4, 3), 2.0))
    emb = tnn.Embedding(6, 2, weight_attr=tinit.Assign(
        np.ones((6, 2), np.float32)), device="cpu")
    assert torch.equal(emb.weight, torch.ones(6, 2))
    frozen = tnn.Linear(4, 3, weight_attr=ParamAttr(trainable=False),
                        device="cpu")
    assert not frozen.weight.requires_grad and frozen.bias.requires_grad
    fmt = TFMT(8, 2, 16, num_layers=2, device="cpu",
               qkv_weight_attrs=[tinit.Constant(0.25), None])
    assert torch.equal(fmt.qkv_weights[0], torch.full((3, 2, 4, 8), 0.25))
    assert fmt.qkv_weights[1].std() > 0


def test_fresh_linear_and_embedding_have_the_reference_stds():
    lin = tnn.Linear(512, 512, device="cpu")
    assert torch.isfinite(lin.weight).all()
    assert abs(lin.weight.std().item() / math.sqrt(2 / 1024) - 1) <= 0.05
    assert abs(lin.weight.mean().item()) <= 0.05 * math.sqrt(2 / 1024)
    assert torch.equal(lin.bias, torch.zeros(512))
    emb = tnn.Embedding(1000, 64, device="cpu", dtype=torch.bfloat16)
    w = emb.weight.float()
    assert torch.isfinite(w).all()
    assert abs(w.std().item() - 1) <= 0.05 and abs(w.mean().item()) <= 0.05


def _close_std(got, want):
    if want == 0:
        return got == 0
    return abs(got / want - 1) <= 0.05


def test_fresh_fused_multi_transformer_has_the_reference_stds():
    paddle.seed(0)
    ref = JFMT(128, 4, 512, num_layers=2)
    port = TFMT(128, 4, 512, num_layers=2, device="cpu")
    want = {n: np.asarray(p._data) for n, p in ref.named_parameters()}
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n].detach().numpy()
        assert np.isfinite(g).all(), n
        assert _close_std(float(g.std()), float(w.std())), n
        assert abs(float(g.mean()) - float(w.mean())) <= 0.05 * max(
            float(w.std()), 1e-6), n


def test_fresh_llama_moe_experts_have_the_reference_stds():
    paddle.seed(0)
    cfg = dict(hidden_size=256, moe_intermediate_size=512, num_experts=4)
    ref = jllama.LlamaMoEMLP(jllama.tiny_moe_llama_config(**cfg))
    port = tllama.LlamaMoEMLP(tllama.tiny_moe_llama_config(**cfg),
                              device="cpu", dtype=torch.float32)
    want = {n: np.asarray(p._data) for n, p in ref.named_parameters()}
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n].detach().numpy()
        assert np.isfinite(g).all(), n
        assert _close_std(float(g.std()), float(w.std())), n
    assert _close_std(float(got["experts_up"].detach().std()), 0.02)


class _JBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.layers = jnn.LayerList([jnn.Linear(4, 6), jnn.Linear(6, 2)])
        self.scales = jnn.ParameterList([
            self.create_parameter([3], default_initializer=jinit.Constant(
                1.0)), self.create_parameter([2, 3])])
        self.gain = self.create_parameter([5], is_bias=True)
        self.table = jnn.Embedding(7, 3)


class _TBlock(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.layers = tnn.LayerList([tnn.Linear(4, 6, device="cpu"),
                                     tnn.Linear(6, 2, device="cpu")])
        self.scales = tnn.ParameterList([
            self.create_parameter([3], default_initializer=tinit.Constant(
                1.0)), self.create_parameter([2, 3])])
        self.gain = self.create_parameter([5], is_bias=True)
        self.table = tnn.Embedding(7, 3, device="cpu")


def test_container_and_create_parameter_names_equal_the_reference():
    paddle.seed(1)
    ref, port = _JBlock(), _TBlock()
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    got = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    assert got == want
    assert torch.equal(port.scales[0], torch.ones(3))
    assert torch.equal(port.gain, torch.zeros(5))
    assert len(port.sublayers()) == len(ref.sublayers())
    arrays = {n: np.asarray(p._data) for n, p in ref.named_parameters()}
    missing, unexpected = port.set_state_dict(arrays)
    assert missing == [] and unexpected == []
    for n, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])
    missing, unexpected = port.set_state_dict({"nope": np.zeros(1)})
    assert unexpected == ["nope"] and len(missing) == len(arrays)
    port.layers.append(tnn.Linear(2, 2, device="cpu"))
    ref.layers.append(jnn.Linear(2, 2))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
