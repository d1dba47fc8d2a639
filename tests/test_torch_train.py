"""Training steps of the port against paddle_tpu's eager loop on the same
weights and batch: ``loss = model.loss(ids, labels); loss.backward();
opt.step(); opt.clear_grad()`` with ``AdamW`` over a ``LinearWarmup`` of a
``CosineAnnealingDecay``, weight decay off for biases and norms, and
``ClipGradByGlobalNorm(1.0)``, on a 2-layer GPT of hidden 128.

* f32, four steps, on the general and the packed attention routes: each
  step's loss atol 1e-5, the final parameters atol 2e-5 (Adam divides by
  the root of the second moment, so a gradient's rounding difference moves
  a parameter by up to its relative size times the step; the steps are
  1e-3). The K third of each ``qkv_proj.bias`` has a gradient of exactly
  zero in exact arithmetic (a per-row constant in the logits, which the
  softmax ignores), so Adam turns its rounding noise into steps of the
  learning rate's size: those entries are held to the sum of the steps;
* O2 (``amp.decorate`` to bf16, f32 master weights): the losses atol 2e-3.
  The two frameworks round bf16 products at other places, and Adam turns
  a near-zero gradient of either sign into a step of the learning rate's
  size, so every final bf16 parameter is held within two bf16 ulps plus
  twice the steps' learning rates (at most 1e-3 each) of the reference's, and 97% of each tensor
  within two ulps plus 1e-5 (about 1% fall outside on this batch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import gpt_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig

from test_torch_gpt import (TINY, batch, load_jax,  # noqa: F401
                            no_jax_mesh, route_flags, tiny_gpt_arrays)
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

STEPS = 4


def decays(name):
    """AdamW's ``apply_decay_param_fun``: matrices decay, biases and norm
    scales do not."""
    return not (name.endswith(".bias") or ".ln_" in name)


def assert_params_close(got, want, within):
    """``within(w)`` is the tolerance array for reference values ``w``;
    the K bias entries get the sum of the steps (see the docstring)."""
    h = TINY["hidden_size"]
    for name, w in want.items():
        tol = np.broadcast_to(within(w), w.shape).copy()
        if name.endswith("qkv_proj.bias"):
            tol[h:2 * h] = np.maximum(tol[h:2 * h], 1.01 * STEPS * 1e-3)
        diff = np.abs(got[name] - w)
        assert np.all(diff <= tol), (name, float((diff - tol).max()))


def _opt(mod, nn_mod, params):
    sched = mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(1e-3, 10), 2,
                                0.0, 1e-3)
    return sched, mod.AdamW(learning_rate=sched, parameters=params,
                            weight_decay=0.01, apply_decay_param_fun=decays,
                            grad_clip=nn_mod.ClipGradByGlobalNorm(1.0))


def train_jax(arrays, ids, labels, o2=False):
    jm = load_jax(JaxGPT(JaxGPTConfig(**TINY)), arrays)
    params = []
    for name, p in jm.named_parameters():
        p.name = name  # what apply_decay_param_fun reads
        params.append(p)
    if o2:
        jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    sched, opt = _opt(jopt, jnn, params)
    jm.train()
    losses = []
    ti, tl = (Tensor._wrap(jnp.asarray(a, jnp.int32)) for a in (ids, labels))
    for _ in range(STEPS):
        loss = jm.loss(ti, tl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    return losses, {n: np.asarray(p._data.astype(jnp.float32))
                    for n, p in jm.named_parameters()}


def train_port(arrays, ids, labels, o2=False):
    tm = gpt_from_numpy(GPTConfig(**TINY), arrays, device="cpu")
    sched, opt = _opt(topt, tnn, list(tm.named_parameters()))
    if o2:
        tm, opt = tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    tm.train()
    losses = []
    ti, tl = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(STEPS):
        loss = tm.loss(ti, tl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    return losses, opt, {n: p.detach().float().numpy()
                         for n, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def data():
    ids, labels = batch(21, TINY["vocab_size"], b=2, s=32)
    return tiny_gpt_arrays(5), ids, labels


@pytest.mark.parametrize("packed", [False, True], ids=["general", "packed"])
def test_f32_steps_match_reference(data, route_flags, packed):
    arrays, ids, labels = data
    route_flags(packed)
    want_l, want_p = train_jax(arrays, ids, labels)
    got_l, opt, got_p = train_port(arrays, ids, labels)
    np.testing.assert_allclose(got_l, want_l, atol=1e-5, rtol=0)
    assert got_l[-1] < got_l[0]
    assert_params_close(got_p, want_p, lambda w: 2e-5)
    for name, w in want_p.items():
        assert not np.array_equal(w, arrays[name]), name  # every one moved
    assert opt.state_dict()["step"] == STEPS


def test_o2_bf16_steps_match_reference(data, route_flags):
    arrays, ids, labels = data
    route_flags(False)
    want_l, want_p = train_jax(arrays, ids, labels, o2=True)
    got_l, opt, got_p = train_port(arrays, ids, labels, o2=True)
    np.testing.assert_allclose(got_l, want_l, atol=2e-3, rtol=0)
    assert got_l[-1] < got_l[0]
    assert len(opt._master_weights) == len(want_p)
    assert_params_close(got_p, want_p,
                        lambda w: 2 * np.abs(w) * 2.0 ** -7 + 2 * STEPS * 1e-3)
    h = TINY["hidden_size"]
    for name, w in want_p.items():
        near = np.abs(got_p[name] - w) <= 2 * np.abs(w) * 2.0 ** -7 + 1e-5
        if name.endswith("qkv_proj.bias"):
            near = np.concatenate([near[:h], near[2 * h:]])  # not the K bias
        assert near.mean() >= 0.97, (name, float(near.mean()))
