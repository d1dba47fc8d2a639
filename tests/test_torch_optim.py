"""The port's optimizers, LR schedulers, gradient clips and AMP against
paddle_tpu's, fed the same numpy parameters and gradients:

* every update rule over five steps (parameters and state), f32, atol 1e-6
  (the same arithmetic in another order; Lamb's trust ratio divides two
  norms);
* each scheduler's learning rate over 20 steps (plain Python in both);
* the three clip classes and ``clip_grad_norm_`` through an SGD step;
* bf16 parameters with f32 master weights (the O2 recipe): the master
  copies atol 1e-6, the bf16 parameters exactly;
* the ``state_dict`` round trip, ``GradScaler`` and ``decorate``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nn.clip import clip_grad_norm_ as jax_clip_grad_norm_

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"w": (3, 4), "b": (5,)}


def _arrays(seed, steps=5):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_jax(cls, params, grads, dtype="float32", **kw):
    ps = {n: paddle.framework.Parameter(a, dtype=dtype, name=n)
          for n, a in params.items()}
    opt = cls(parameters=list(ps.values()), **kw)
    for g in grads:
        for n, p in ps.items():
            p.grad = Tensor._wrap(jnp.asarray(g[n]).astype(p._data.dtype))
        opt.step()
        opt.clear_grad()
    return opt, {n: np.asarray(p._data.astype(jnp.float32))
                 for n, p in ps.items()}


def _run_port(cls, params, grads, dtype=torch.float32, **kw):
    ps = {n: torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
          for n, a in params.items()}
    opt = cls(parameters=list(ps.items()), **kw)
    for g in grads:
        for n, p in ps.items():
            p.grad = torch.from_numpy(g[n]).to(dtype)
        opt.step()
        opt.clear_grad()
    return opt, {n: p.detach().float().numpy() for n, p in ps.items()}


def _state(opt, names):
    sd = opt.state_dict()
    out = {}
    for k, v in sd.items():
        if k.split(".")[0] in names:
            out[k] = np.asarray(v.numpy() if hasattr(v, "numpy") else v,
                                np.float32)
    return out


RULES = {
    "SGD": dict(learning_rate=0.1),
    "SGD wd": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "Momentum nesterov wd": dict(learning_rate=0.1, momentum=0.8,
                                 use_nesterov=True, weight_decay=0.01),
    "Adam": dict(learning_rate=0.01),
    "Adam wd": dict(learning_rate=0.01, weight_decay=0.05),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
    "AdamW decay fn": dict(learning_rate=0.01, weight_decay=0.1,
                           apply_decay_param_fun=lambda n: n == "w"),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSProp centered": dict(learning_rate=0.01, centered=True),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01),
    "Lamb exclude": dict(learning_rate=0.01, lamb_weight_decay=0.01,
                         exclude_from_weight_decay_fn=lambda p:
                         len(p.shape) == 1),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_update_rule_matches_reference(rule):
    kw = RULES[rule]
    cls_name = rule.split()[0]
    params, grads = _arrays(len(rule))
    jo, want = _run_jax(getattr(jopt, cls_name), params, grads, **kw)
    to, got = _run_port(getattr(topt, cls_name), params, grads, **kw)
    for n in SHAPES:
        np.testing.assert_allclose(got[n], want[n], atol=1e-6, rtol=0,
                                   err_msg=n)
    ws, gs = _state(jo, SHAPES), _state(to, SHAPES)
    assert sorted(ws) == sorted(gs)
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    assert jo.state_dict()["step"] == to.state_dict()["step"] == 5


@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum"])
def test_bf16_params_keep_f32_master_weights(cls):
    params, grads = _arrays(7)
    kw = dict(learning_rate=0.01)
    jo, want = _run_jax(getattr(jopt, cls), params, grads, dtype="bfloat16",
                        **kw)
    to, got = _run_port(getattr(topt, cls), params, grads,
                        dtype=torch.bfloat16, **kw)
    for n in SHAPES:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        master_w = np.asarray(jo._master_weights[id(next(
            p for p in jo._params if p.name == n))])
        master_t = to._master_weights[id(dict(zip(
            to._names, to._params))[n])]
        assert master_t.dtype == torch.float32
        np.testing.assert_allclose(master_t.numpy(), master_w, atol=1e-6,
                                   rtol=0, err_msg=n)


def test_bf16_without_multi_precision_updates_in_place():
    params, grads = _arrays(8, steps=2)
    to, got = _run_port(topt.AdamW, params, grads, dtype=torch.bfloat16,
                        learning_rate=0.01, multi_precision=False)
    assert not to._master_weights
    jo, want = _run_jax(jopt.AdamW, params, grads, dtype="bfloat16",
                        learning_rate=0.01, multi_precision=False)
    for n in SHAPES:
        np.testing.assert_allclose(got[n], want[n], atol=1e-2, rtol=0)


SCHEDULERS = {
    "ConstantLR": lambda m: m.ConstantLR(0.1),
    "NoamDecay": lambda m: m.NoamDecay(64, 5, learning_rate=0.5),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.9),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.2),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 8, end_lr=0.01,
                                                   power=2.0),
    "PolynomialDecay cycle": lambda m: m.PolynomialDecay(0.1, 6, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 5, 0.0, 0.1),
    "LinearWarmup cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, 15), 5, 0.0, 0.1),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9], [0.1, 0.05, 0.01]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, 7,
                                                             eta_min=0.01),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 11], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, 3, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 20),
    "OneCycleLR three phase": lambda m: m.OneCycleLR(
        0.1, 20, three_phase=True, anneal_strategy="linear"),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1,
                                                           lambda e: 0.9),
    "LinearLR": lambda m: m.LinearLR(0.1, 10),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, 4, T_mult=2, eta_min=0.001),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 4),
    "CyclicLR triangular2": lambda m: m.CyclicLR(0.01, 0.1, 3, 5,
                                                 mode="triangular2"),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_values_over_20_steps(name):
    vals = []
    for mod in (jopt.lr, topt.lr):
        s = SCHEDULERS[name](mod)
        seq = []
        for _ in range(20):
            seq.append(s())
            s.step()
        vals.append(seq)
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12, atol=0)


def test_reduce_on_plateau_matches_reference():
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8]
    seqs = []
    for mod in (jopt.lr, topt.lr):
        s = mod.ReduceOnPlateau(0.1, patience=2, factor=0.5)
        seq = []
        for m in metrics:
            s.step(m)
            seq.append(s())
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[1][-1] < 0.1


def test_optimizer_reads_the_scheduler():
    params, grads = _arrays(9, steps=4)
    lrs = []
    for mod, run in ((jopt, _run_jax), (topt, _run_port)):
        sched = mod.lr.StepDecay(0.1, 2, gamma=0.5)
        opt, got = run(mod.SGD, params, grads[:1], learning_rate=sched)
        lrs.append((opt.get_lr(), got))
    assert lrs[0][0] == lrs[1][0]
    for n in SHAPES:
        np.testing.assert_allclose(lrs[1][1][n], lrs[0][1][n], atol=1e-7)
    opt = topt.SGD(learning_rate=topt.lr.StepDecay(0.1, 2),
                   parameters=[torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)


CLIPS = {
    "global norm": lambda m: m.ClipGradByGlobalNorm(1.0),
    "global norm, no clip": lambda m: m.ClipGradByGlobalNorm(100.0),
    "norm": lambda m: m.ClipGradByNorm(0.5),
    "value": lambda m: m.ClipGradByValue(0.3),
    "value min max": lambda m: m.ClipGradByValue(0.5, min=-0.1),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clip_through_sgd_matches_reference(name):
    params, grads = _arrays(10, steps=2)
    _, want = _run_jax(jopt.SGD, params, grads, learning_rate=1.0,
                       grad_clip=CLIPS[name](jnn))
    _, got = _run_port(topt.SGD, params, grads, learning_rate=1.0,
                       grad_clip=CLIPS[name](tnn))
    for n in SHAPES:
        np.testing.assert_allclose(got[n], want[n], atol=1e-6, rtol=0)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    _, grads = _arrays(11, steps=1)
    jps, tps = [], []
    for n, g in grads[0].items():
        jp = paddle.framework.Parameter(np.zeros_like(g), name=n)
        jp.grad = Tensor._wrap(jnp.asarray(g * 3))
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g * 3)
        tps.append(tp)
    want = float(jax_clip_grad_norm_(jps, 1.0, norm_type).numpy())
    got = float(tnn.clip_grad_norm_(tps, 1.0, norm_type))
    assert abs(got - want) < 1e-5 * max(1.0, want)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   atol=1e-6, rtol=0)


def test_state_dict_round_trip():
    params, grads = _arrays(12, steps=3)
    to, _ = _run_port(topt.AdamW, params, grads,
                      learning_rate=topt.lr.StepDecay(0.01, 2),
                      dtype=torch.bfloat16)
    sd = to.state_dict()
    assert {"step", "LR_Scheduler", "w.moment1", "w.moment2", "w.master",
            "b.moment1"} <= set(sd)
    ps = {n: torch.nn.Parameter(torch.zeros(s, dtype=torch.bfloat16))
          for n, s in SHAPES.items()}
    fresh = topt.AdamW(learning_rate=topt.lr.StepDecay(0.01, 2),
                       parameters=list(ps.items()))
    fresh.set_state_dict(sd)
    sd2 = fresh.state_dict()
    assert sd2.keys() == sd.keys() and sd2["step"] == 3
    assert sd2["LR_Scheduler"] == sd["LR_Scheduler"]
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(sd2[k], v, atol=0, rtol=0)
    # the restored state continues exactly as the original
    g = {n: torch.from_numpy(a).to(torch.bfloat16)
         for n, a in grads[0].items()}
    orig = dict(zip(to._names, to._params))
    for opt, pm in ((to, orig), (fresh, ps)):
        with torch.no_grad():
            for n, p in pm.items():
                p.copy_(opt._master_weights[id(p)])
                p.grad = g[n].clone()
        opt.step()
    for n in SHAPES:
        torch.testing.assert_close(ps[n], orig[n], atol=0, rtol=0)


def test_minimize_and_clear_grad():
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(learning_rate=0.5, parameters=[w])
    opt.minimize((w * 2.0).sum())
    torch.testing.assert_close(w.detach(), torch.zeros(3))
    assert w.grad is None
    (w * 1.0).sum().backward()
    opt.clear_grad(set_to_zero=True)
    assert w.grad is not None and not w.grad.any()


# --------------------------------------------------------------------- AMP
def test_grad_scaler_matches_reference():
    """Dynamic loss scaling: scale, unscale, skip the step on an inf, halve
    the scale; double it after ``incr_every_n_steps`` good steps."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    seqs = []
    for pkg, opt_mod in ((jamp, jopt), (tamp, topt)):
        if pkg is jamp:
            w = paddle.framework.Parameter(np.ones(2, np.float32))
        else:
            w = torch.nn.Parameter(torch.ones(2))
        opt = opt_mod.SGD(learning_rate=0.1, parameters=[w])
        scaler = pkg.GradScaler(**kw)
        seq = []
        for g in (1.0, float("inf"), 2.0, 3.0, 1.0):
            scaled = scaler.scale(w * g if g != float("inf") else w * 1e38
                                  * 1e38)
            if pkg is jamp:
                scaled.sum().backward()
                scaler.step(opt)
                opt.clear_grad()
                seq.append((scaler._scale, w.numpy().tolist()))
            else:
                scaled.sum().backward()
                scaler.step(opt)
                opt.clear_grad()
                seq.append((scaler._scale, w.detach().numpy().tolist()))
        seqs.append(seq)
    for (sj, wj), (st, wt) in zip(*seqs):
        assert sj == st
        np.testing.assert_allclose(wt, wj, rtol=1e-6)
    assert seqs[1][1][0] == 512.0    # halved after the inf step
    assert seqs[1][1][1] == seqs[1][0][1]  # ... which was skipped
    off = tamp.GradScaler(enable=False)
    loss = torch.ones(())
    assert off.scale(loss) is loss and float(off.get_loss_scaling()) == 1.0


def test_decorate_casts_params_and_keeps_master_weights():
    lin = tnn.Linear(4, 3, device="cpu")
    torch.nn.init.normal_(lin.weight)
    w32 = lin.weight.detach().clone()
    opt = topt.AdamW(learning_rate=0.1, parameters=lin.named_parameters())
    model, opt2 = tamp.decorate(lin, opt, level="O2", dtype="bfloat16")
    assert model is lin and opt2 is opt
    assert lin.weight.dtype == torch.bfloat16 and lin.bias.dtype == \
        torch.bfloat16
    lin(torch.ones((2, 4), dtype=torch.bfloat16)).float().sum().backward()
    opt.step()
    master = opt._master_weights[id(lin.weight)]
    assert master.dtype == torch.float32
    assert torch.equal(lin.weight, master.to(torch.bfloat16))
    assert (master - w32).abs().max() < 0.2
    lin2 = tnn.Linear(4, 3, device="cpu")
    tamp.decorate(lin2, level="O1")
    assert lin2.weight.dtype == torch.float32


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", ["linear", "attention", "layer_norm",
                                "cross_entropy", "gelu"])
def test_amp_cast_lists_match_reference(level, op):
    """The dtype each op's inputs get under ``auto_cast``, in both
    packages: white-list ops go to bf16 (O1 and O2), black-list ops to
    f32, the rest to bf16 under O2 only."""
    got = []
    for pkg, x in ((jamp, Tensor._wrap(jnp.ones((2,), jnp.float32))),
                   (tamp, torch.ones(2))):
        with pkg.auto_cast(level=level):
            (y,) = pkg.amp_cast(op, x)
        got.append(str(y.dtype).replace("torch.", "").replace("paddle.",
                                                              ""))
    assert got[0] == got[1]
    with tamp.auto_cast(level="O2"):
        (y,) = tamp.amp_cast("layer_norm", torch.ones(2, dtype=torch.bfloat16))
    assert y.dtype == torch.float32
    assert not tamp.is_auto_cast_enabled()


def test_functional_linear_casts_under_auto_cast():
    x = torch.ones((2, 4))
    w = torch.ones((4, 3))
    with tamp.auto_cast(level="O1"):
        y = tnn.functional.linear(x, w, torch.zeros(3))
    assert y.dtype == torch.bfloat16
    assert tnn.functional.linear(x, w).dtype == torch.float32
