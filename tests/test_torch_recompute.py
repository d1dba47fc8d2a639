"""The port's ``fleet.recompute`` (``recompute``, ``recompute_sequential``,
``POLICY_MAP``) against plain autograd and against paddle_tpu's
``recompute`` (``jax.checkpoint``) on the same weights and inputs, f32.

* Gradients through a recomputed ``TransformerEncoderLayer`` equal plain
  autograd's bitwise (the same ops run again on the same inputs), at
  every granularity, and the reference's within 2e-5 (its eager tape
  over naive attention, the port's flash twins).
* RNG: with dropout drawn from an explicit generator the re-run draws the
  forward's mask (gradients equal the plain run's), and the generator is
  left where the plain forward leaves it; ``preserve_rng_state=False``
  draws a fresh mask, so the gradients differ (the control).
* Under ``jit.functional_call`` the region binds the call's tensors: the
  gradients reach them, not the module's own parameters.
* ``"full_attn"`` keeps the Linears' products: the backward runs fewer
  ``aten.mm`` than under ``"full"``.
* ``recompute_sequential`` over 1, 2 and 4 segments equals plain
  autograd and the reference's."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet.recompute import recompute as jrecompute
from paddle_tpu.distributed.fleet.recompute import (
    recompute_sequential as jrecompute_sequential)
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import param_arrays as jparam_arrays

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.convert import state_dict_from_numpy
from paddle_tpu_torch.distributed.fleet import recompute as fleet_recompute
from paddle_tpu_torch.distributed.fleet.recompute import (
    POLICY_MAP, recompute, recompute_sequential)
from paddle_tpu_torch.jit import functional_call
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

D, H, FF = 32, 4, 64
TOL = dict(rtol=2e-5, atol=2e-5)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_layer(seed, dropout=0.0):
    layer = jnn.TransformerEncoderLayer(D, H, FF, dropout=dropout)
    r = np.random.default_rng(seed)
    for _, p in layer.named_parameters():
        p.set_value(jnp.asarray(0.2 * r.standard_normal(tuple(p.shape)),
                                jnp.float32))
    return layer


def _port_layer(jlayer, dropout=0.0, generator=None):
    layer = nn.TransformerEncoderLayer(D, H, FF, dropout=dropout,
                                       device="cpu", generator=generator)
    arrays = {k: np.asarray(v) for k, v in jparam_arrays(jlayer).items()}
    layer.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                          strict=True)
    return layer


def _grads(layer, x, run):
    """Gradients of sum(run(layer, x) ** 2) for the layer's parameters and
    x, in ``named_parameters`` order then x."""
    layer.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    run(layer, xt).square().sum().backward()
    return [p.grad.clone() for _, p in layer.named_parameters()] + \
        [xt.grad.clone()]


def test_fleet_exports_recompute():
    assert fleet_recompute is recompute
    assert set(POLICY_MAP) == {"full", "full_attn", "core_attn"}
    with pytest.raises(ValueError):
        recompute(lambda t: t * 2, torch.ones(2, requires_grad=True),
                  granularity="selective")


@pytest.mark.parametrize("granularity", ["full", "full_attn", "core_attn"])
def test_recompute_layer_matches_plain_and_jax(granularity):
    jlayer = _jax_layer(0)
    layer = _port_layer(jlayer)
    x = _x(1, 2, 12, D)
    want = _grads(layer, x, lambda m, t: m(t))
    got = _grads(layer, x, lambda m, t: recompute(
        m, t, granularity=granularity))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jx = Tensor(jnp.asarray(x))
    jx.stop_gradient = False
    y = jrecompute(jlayer, jx, granularity=granularity)
    (y * y).sum().backward()
    jg = [np.asarray(p.grad._data) for _, p in jlayer.named_parameters()]
    for (name, _), a, b in zip(layer.named_parameters(), got,
                               jg + [np.asarray(jx.grad._data)]):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def test_recompute_replays_the_generators_mask():
    g = torch.Generator().manual_seed(0)
    layer = _port_layer(_jax_layer(2), dropout=0.3, generator=g)
    layer.train()
    x = _x(3, 2, 8, D)
    g.manual_seed(7)
    want = _grads(layer, x, lambda m, t: m(t))
    after_plain = g.get_state()
    g.manual_seed(7)
    got = _grads(layer, x, lambda m, t: recompute(m, t))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g.get_state(), after_plain)
    g.manual_seed(7)
    fresh = _grads(layer, x, lambda m, t: recompute(
        m, t, preserve_rng_state=False))
    assert not all(torch.equal(a, b) for a, b in zip(fresh, want))


def test_recompute_of_a_bound_forward_under_functional_call():
    """``layer.forward`` under recompute (as ``examples/train_bert_torch.py
    --recompute`` installs it), called through ``functional_call`` with
    tensors other than the module's: the re-run in the backward uses the
    call's tensors, and only they get gradients."""
    layer = _port_layer(_jax_layer(4))
    r = np.random.default_rng(5)
    state = {k: (v.detach() + 0.05 * torch.from_numpy(r.standard_normal(
        tuple(v.shape)).astype(np.float32))).requires_grad_()
        for k, v in layer.named_parameters()}
    x = torch.from_numpy(_x(6, 2, 8, D))
    want = torch.autograd.grad(
        functional_call(layer, state, x).square().sum(),
        list(state.values()))
    layer.forward = functools.partial(recompute, layer.forward)
    try:
        got = torch.autograd.grad(
            functional_call(layer, state, x).square().sum(),
            list(state.values()))
    finally:
        del layer.forward
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in layer.parameters())


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_full_attn_keeps_the_linear_products():
    layer = _port_layer(_jax_layer(8))
    x = torch.from_numpy(_x(9, 2, 8, D)).requires_grad_()
    counts = {}
    for gran in ("full", "full_attn"):
        y = recompute(layer, x, granularity=gran).square().sum()
        with _CountMM() as mode:
            y.backward()
        counts[gran] = mode.n
    assert counts["full_attn"] < counts["full"], counts


def test_recompute_of_a_function():
    w = torch.from_numpy(_x(10, 5, 5)).requires_grad_()
    x = torch.from_numpy(_x(11, 3, 5)).requires_grad_()

    def f(a, scale=1.0):
        return torch.tanh(a @ w) * scale

    want = torch.autograd.grad(f(x, scale=2.0).sum(), (w, x))
    got = torch.autograd.grad(recompute(f, x, scale=2.0).sum(), (w, x))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_recompute_sequential_matches_plain_and_jax(segments):
    jlayers = [jnn.Linear(D, D) for _ in range(4)]
    r = np.random.default_rng(12)
    for lay in jlayers:
        for _, p in lay.named_parameters():
            p.set_value(jnp.asarray(0.2 * r.standard_normal(tuple(p.shape)),
                                    jnp.float32))
    layers = []
    for lay in jlayers:
        t = nn.Linear(D, D, device="cpu")
        arrays = {k: np.asarray(v) for k, v in jparam_arrays(lay).items()}
        t.load_state_dict(state_dict_from_numpy(arrays, device="cpu"))
        layers.append(t)
    seq = nn.Sequential(*layers)
    x = _x(13, 3, D)

    def run(fn):
        for lay in layers:
            lay.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_()
        fn(xt).square().sum().backward()
        return [p.grad.clone() for p in seq.parameters()] + [xt.grad]

    want = run(seq)
    got = run(lambda t: recompute_sequential({"segments": segments}, seq,
                                             t))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jx = Tensor(jnp.asarray(x))
    jx.stop_gradient = False
    y = jrecompute_sequential({"segments": segments}, jlayers, jx)
    (y * y).sum().backward()
    jg = [np.asarray(p.grad._data) for lay in jlayers
          for _, p in lay.named_parameters()]
    for a, b in zip(got, jg + [np.asarray(jx.grad._data)]):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("segments", [1, 2])
def test_recompute_sequential_under_functional_call(segments):
    """``recompute_sequential`` called through ``functional_call`` with
    tensors other than the module's: each chunk's re-run in the backward
    uses the call's tensors (the gradients equal the plain functional
    call's bitwise), and the module's own parameters get none."""
    seq = nn.Sequential(*[nn.Linear(D, D, device="cpu") for _ in range(4)])
    r = np.random.default_rng(14)

    def draw(shape):
        return torch.from_numpy(0.2 * r.standard_normal(shape).astype(
            np.float32))

    with torch.no_grad():
        for p in seq.parameters():
            p.copy_(draw(tuple(p.shape)))
    state = {k: (v.detach() + 0.25 * draw(tuple(v.shape))).requires_grad_()
             for k, v in seq.named_parameters()}
    x = torch.from_numpy(_x(15, 3, D))
    want = torch.autograd.grad(
        functional_call(seq, state, x).square().sum(), list(state.values()))

    class Wrapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.seq = seq

        def forward(self, t):
            return recompute_sequential({"segments": segments}, self.seq, t)

    wrapped = Wrapped()
    got = torch.autograd.grad(
        functional_call(wrapped, {"seq." + k: v for k, v in state.items()},
                        x).square().sum(),
        list(state.values()))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in seq.parameters())
