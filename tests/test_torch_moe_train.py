"""MoE training at one rank in the port against paddle_tpu's
``incubate.distributed.models.moe``, fed the same numpy inputs and
weights (loaded by name).

Tolerances (f32; the same arithmetic, summed in another order):

* routing primitives: integers exact, dispatch / combine 1e-6;
* the three gates: values and aux loss 1e-6, indices exact;
* ``MoELayer`` forward: 1e-5, over gate x top-k x dense / ragged /
  dropless x capacity (generous, dropping);
* gradients of the input, the gate and every expert parameter against the
  JAX tape: 1e-5 (absolute and relative);
* the grouped matmul's ``autograd.Function`` (plain route) against
  ``jax.grad`` of ``grouped_matmul_ref``: 1e-5;
* the MoE clip: 1e-6; four AdamW steps of a two-block MoE stack: each
  step's loss within 1e-5 relative.

The reference's ragged path mishandles random routing's dropped second
choices (expert ``-1``); the port gives the dense path's answer there, and
``test_reference_ragged_path_shifts_segments_on_dropped_choices`` records
the reference's disagreement.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul_ref as jax_grouped_ref)

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import parallel as tparallel
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.ops.cuda.grouped_matmul import ragged_dot
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

D, F, E = 8, 16, 4
TOL = dict(atol=1e-5, rtol=1e-5)


def _j(a):
    return Tensor._wrap(jnp.asarray(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _weights(layer, seed):
    """numpy arrays for each of the JAX layer's parameters, by name."""
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(tuple(p.shape)) * 0.5).astype(np.float32)
            for n, p in layer.named_parameters()}


# ------------------------------------------------------ routing primitives
def _idx(rng, t, k, drop=False):
    idx = rng.integers(0, E, (t, k)).astype(np.int32)
    if drop:
        idx[::3, -1] = -1
    return idx


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop", [False, True])
def test_count_and_limit_by_capacity(k, drop):
    idx = _idx(np.random.default_rng(k + 2 * drop), 13, k, drop)
    np.testing.assert_array_equal(
        _np(tmoe.count_by_gate(torch.from_numpy(idx), E)),
        np.asarray(jmoe.count_by_gate(jnp.asarray(idx), E)))
    for cap in (1, 3, 20):
        got = tmoe.limit_by_capacity(torch.from_numpy(idx), E, cap)
        want = jmoe.limit_by_capacity(jnp.asarray(idx), E, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("k,cap,drop", [(1, 2, False), (2, 3, False),
                                        (2, 3, True), (2, 16, True)])
def test_gshard_dispatch(k, cap, drop):
    rng = np.random.default_rng(cap)
    idx = _idx(rng, 11, k, drop)
    val = rng.random((11, k)).astype(np.float32)
    got = tmoe.gshard_dispatch(torch.from_numpy(val), torch.from_numpy(idx),
                               E, cap)
    want = jmoe.gshard_dispatch(jnp.asarray(val), jnp.asarray(idx), E, cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("cap", [2, None])
def test_ragged_routing(drop, cap):
    rng = np.random.default_rng(5)
    idx = _idx(rng, 9, 2, drop)
    val = rng.random((9, 2)).astype(np.float32)
    tok, e, w, gs = tmoe.ragged_routing(torch.from_numpy(idx),
                                        torch.from_numpy(val), E, cap)
    np.testing.assert_array_equal(_np(gs), np.asarray(jmoe.count_by_gate(
        jnp.asarray(idx), E)))
    kept = int((idx >= 0).sum())
    assert (_np(e)[:kept] >= 0).all() and (_np(e)[kept:] == -1).all()
    assert np.all(np.diff(_np(e)[:kept]) >= 0)
    assert (_np(w)[kept:] == 0).all()
    if not drop:  # without -1 pairs the order and weights are the JAX ones
        jt, je, jw, _ = jmoe.ragged_routing(jnp.asarray(idx),
                                            jnp.asarray(val), E, cap)
        for g, want in zip((tok, e, w), (jt, je, jw)):
            np.testing.assert_array_equal(_np(g), np.asarray(want))


def test_padded_flops_fraction():
    for args in ((8, 1228, 4096, 2), (4, 3, 12, 1), (4, 100, 12, 2)):
        assert tmoe.padded_flops_fraction(*args) == \
            jmoe.padded_flops_fraction(*args)


# ------------------------------------------------------------------ gates
GATES = {
    "naive1": (lambda m, **kw: m.NaiveGate(D, E, topk=1, **kw)),
    "naive2": (lambda m, **kw: m.NaiveGate(D, E, topk=2, **kw)),
    "gshard": (lambda m, **kw: m.GShardGate(D, E, random_routing=False,
                                            **kw)),
    "switch": (lambda m, **kw: m.SwitchGate(D, E, switch_eps=0.0, **kw)),
}


def _gate_pair(name, seed=0):
    paddle.seed(seed)
    jg = GATES[name](jmoe)
    tg = GATES[name](tmoe, device="cpu")
    w = _weights(jg, seed)
    jg.set_state_dict(w)
    tg.set_state_dict(w)
    return jg, tg


@pytest.mark.parametrize("name", list(GATES))
def test_gates_match_reference(name):
    jg, tg = _gate_pair(name)
    x = np.random.default_rng(1).standard_normal((10, D)).astype(np.float32)
    jv, ji = jg(_j(x))[:2]
    tv, ti = tg(torch.from_numpy(x))[:2]
    np.testing.assert_array_equal(_np(ti), np.asarray(ji._data))
    np.testing.assert_allclose(_np(tv), np.asarray(jv._data), atol=1e-6)
    ja, ta = jg.get_loss(), tg.get_loss()
    assert (ja is None) == (ta is None) == name.startswith("naive")
    if ta is not None:
        np.testing.assert_allclose(_np(ta), np.asarray(ja._data), atol=1e-6)
        assert tg.get_loss() is None  # get_loss clears
    if name.startswith("naive"):
        _, _, logits = tg(torch.from_numpy(x), return_all_scores=True)
        np.testing.assert_allclose(
            _np(logits), np.asarray(jg(_j(x), return_all_scores=True)[2]
                                    ._data), atol=1e-6)


def test_gshard_random_routing_drops_second_choices_by_the_rule():
    """``2 * val_2 < r`` drops the second choice (expert -1), ``r`` the
    gate generator's f32 uniform, one a token; eval draws nothing; with no
    generator each training forward takes the next ``framework.random``
    generator."""
    g = tmoe.GShardGate(D, E, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, D)).astype(np.float32))
    g.train()
    val, idx = g(x)
    g.random_routing = False
    val0, idx0 = g(x)
    r = torch.rand(64, generator=torch.Generator().manual_seed(5))
    want = torch.where(2 * val0[:, 1] < r, -1, idx0[:, 1])
    assert torch.equal(val, val0) and torch.equal(idx[:, 0], idx0[:, 0])
    assert torch.equal(idx[:, 1], want)
    assert 0 < int((idx[:, 1] == -1).sum()) < 64
    g.random_routing = True
    g.eval()
    assert torch.equal(g(x)[1], idx0)
    g.train()
    g.generator = None
    prandom.seed(4)
    g(x)
    assert prandom.get_rng_state()["counter"] == 1


def test_switch_jitter_rule():
    g = tmoe.SwitchGate(D, E, switch_eps=0.1, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, D)).astype(np.float32))
    g.train()
    val, idx = g(x)
    noise = torch.empty((32, E)).uniform_(
        0.9, 1.1, generator=torch.Generator().manual_seed(7))
    want_v, want_i = torch.topk(torch.softmax(g.gate(x) * noise, -1), 1)
    assert torch.equal(idx, want_i) and torch.equal(val, want_v)
    g.eval()
    assert torch.equal(g(x)[1], torch.topk(g.gate(x), 1)[1])


# ------------------------------------------------------------- MoE layer
PATHS = {"dense": dict(use_ragged=False), "ragged": dict(use_ragged=True),
         "dropless": dict(dropless=True)}


def _layer_pair(gate, path, cf, seed=0, act="relu"):
    """A JAX and a port ``MoELayer`` with equal weights, in training mode.
    ``gate`` is a key of GATES or a (jax gate, port gate) pair."""
    paddle.seed(seed)
    if isinstance(gate, str):
        jg, tg = GATES[gate](jmoe), GATES[gate](tmoe, device="cpu")
    else:
        jg, tg = gate
    kw = dict(capacity_factor=cf, **PATHS[path])
    jl = jmoe.MoELayer(D, [jmoe.ExpertFFN(D, F, act) for _ in range(E)],
                       gate=jg, **kw)
    tl = tmoe.MoELayer(D, [tmoe.ExpertFFN(D, F, act, device="cpu")
                           for _ in range(E)], gate=tg, **kw)
    w = _weights(jl, seed)
    jl.set_state_dict(w)
    assert tl.set_state_dict(w) == ([], [])
    return jl.train(), tl.train()


def _x(seed=1, shape=(2, 6, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["generous", "drops"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("gate", list(GATES))
def test_moe_layer_forward_matches_reference(gate, path, cf):
    jl, tl = _layer_pair(gate, path, cf, act="gelu")
    x = _x()
    want = np.asarray(jl(_j(x))._data)
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert tl.last_padded_fraction == jl.last_padded_fraction
    ja, ta = jl.gate.get_loss(), tl.gate.get_loss()
    if gate.startswith("naive"):
        assert ta is None
    else:
        np.testing.assert_allclose(_np(ta), np.asarray(ja._data), atol=1e-6)


def _grads_jax(jl, x):
    for p in jl.parameters():
        p.grad = None
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = jl(xt)
    aux = jl.gate.get_loss()
    loss = (out * out).mean()
    if aux is not None:
        loss = loss + 0.01 * aux.mean()
    loss.backward()
    g = {n: np.asarray(p.grad._data) for n, p in jl.named_parameters()
         if p.grad is not None}
    return float(loss._data), np.asarray(xt.grad._data), g


def _grads_port(tl, x):
    for p in tl.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl(xt)
    aux = tl.gate.get_loss()
    loss = (out * out).mean()
    if aux is not None:
        loss = loss + 0.01 * aux.mean()
    loss.backward()
    g = {n: _np(p.grad) for n, p in tl.named_parameters()
         if p.grad is not None}
    return float(loss.detach()), _np(xt.grad), g


def _assert_grads(got, want):
    assert abs(got[0] - want[0]) <= 1e-5 * max(1.0, abs(want[0]))
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], err_msg=n, **TOL)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("gate", ["naive2", "gshard", "switch"])
def test_moe_layer_gradients_match_reference_tape(gate, path):
    jl, tl = _layer_pair(gate, path, 0.5, seed=3)
    x = _x(4)
    want, got = _grads_jax(jl, x), _grads_port(tl, x)
    _assert_grads(got, want)
    # the gate and every expert parameter get a gradient
    assert any(n.startswith("gate.") for n in got[2])
    assert len([n for n in got[2] if n.startswith("experts.")]) == 4 * E


class _JPreset(jmoe.BaseGate):
    """A gate that returns fixed routing (random routing's output)."""

    def __init__(self, val, idx):
        super().__init__(E)
        self.top_k = idx.shape[1]
        self.val, self.idx = val, idx

    def forward(self, inp):
        return _j(self.val), _j(self.idx)


class _TPreset(tmoe.BaseGate):
    def __init__(self, val, idx):
        super().__init__(E)
        self.top_k = idx.shape[1]
        self.val, self.idx = torch.from_numpy(val), torch.from_numpy(idx)

    def forward(self, inp):
        return self.val, self.idx


def _routed(t=12, seed=6):
    """GShard routing with random routing's drops, made in numpy: top-2 of
    a softmax, the second choice -1 where ``2 * val_2 < r``."""
    rng = np.random.default_rng(seed)
    p = rng.random((t, E)).astype(np.float32) ** 3
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2].astype(np.int32)
    val = np.take_along_axis(p, idx, -1)
    r = rng.random(t).astype(np.float32)
    idx[:, 1] = np.where(2 * val[:, 1] < r, -1, idx[:, 1])
    assert 0 < (idx[:, 1] == -1).sum() < t
    return val, idx


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["generous", "drops"])
def test_port_ragged_equals_reference_dense_with_dropped_choices(cf):
    """With expert -1 in the routing, the port's ragged and dropless paths
    give the JAX dense path's output and gradients (the dense path
    dispatches nothing for a -1 pair)."""
    val, idx = _routed()
    x = _x(7)
    jl, tl = _layer_pair((_JPreset(val, idx), _TPreset(val, idx)),
                         "dense", cf)
    want = _grads_jax(jl, x)
    for path in ("ragged", "dropless"):
        tl.use_ragged, tl.dropless = path == "ragged", path == "dropless"
        if path == "dropless":
            jl.capacity_factor = tl.capacity_factor = 100.0
            want = _grads_jax(jl, x)
        _assert_grads(_grads_port(tl, x), want)


def test_reference_ragged_path_shifts_segments_on_dropped_choices():
    """The divergence, recorded: the reference's own ragged path sorts the
    -1 pairs first without counting them, so its answer moves away from
    its dense path's; the port's ragged path keeps the dense answer."""
    val, idx = _routed()
    x = _x(7)
    jd, _ = _layer_pair((_JPreset(val, idx), _TPreset(val, idx)), "dense",
                        4.0)
    jr, tr = _layer_pair((_JPreset(val, idx), _TPreset(val, idx)), "ragged",
                         4.0)
    dense = np.asarray(jd(_j(x))._data)
    assert np.abs(np.asarray(jr(_j(x))._data) - dense).max() > 1e-2
    np.testing.assert_allclose(_np(tr(torch.from_numpy(x))), dense, **TOL)


def test_reference_parameters_load_through_convert():
    """The JAX ``MoELayer``'s parameters (numpy, by name) load into the
    port's through ``convert.state_dict_from_numpy``, strictly: the names
    and layouts match."""
    from paddle_tpu_torch.convert import state_dict_from_numpy

    jl, tl = _layer_pair("gshard", "ragged", 2.0)
    arrays = {n: np.asarray(p._data) * 2 for n, p in jl.named_parameters()}
    tl.load_state_dict(state_dict_from_numpy(arrays, device="cpu"),
                       strict=True)
    for n, p in tl.named_parameters():
        np.testing.assert_array_equal(_np(p), arrays[n])


def test_expert_parallel_mesh_raises():
    _, tl = _layer_pair("gshard", "ragged", 2.0)
    mesh = SimpleNamespace(mesh_dim_names=("dp", "pp", "sharding", "sep",
                                           "mp"), shape=(2, 1, 1, 1, 1))
    prev = tparallel._global_mesh
    tparallel.set_mesh(mesh)
    try:
        with pytest.raises(TypeError, match="expert parallelism"):
            tl(torch.from_numpy(_x()))
        mesh.shape = (1, 1, 1, 1, 2)
        tl(torch.from_numpy(_x()))  # the expert axis (dp) is 1
    finally:
        tparallel.set_mesh(prev)


def test_layer_surface():
    with pytest.raises(ValueError):
        tmoe.MoELayer(D, [tmoe.ExpertFFN(D, F, device="cpu")
                          for _ in range(2)], use_ragged=False,
                      dropless=True)
    with pytest.raises(ValueError):
        tmoe.MoELayer(D, [tmoe.ExpertFFN(D, F, device="cpu"),
                          tmoe.ExpertFFN(D, 2 * F, device="cpu")])
    layer = tmoe.MoELayer(D, [tnn.Linear(D, D, device="cpu")
                              for _ in range(E)], gate={"type": "switch",
                                                        "top_k": 1})
    assert isinstance(layer.gate, tmoe.SwitchGate)
    assert not layer._ragged_active()
    with pytest.raises(ValueError):
        layer.use_ragged = True
        layer._ragged_active()
    assert sorted(jmoe.__all__) == sorted(tmoe.__all__)


# ------------------------------------------- the grouped matmul's gradient
GROUPS = {"random": (40, [7, 13, 3, 17]), "empty": (24, [0, 24, 0, 0]),
          "tail": (30, [5, 0, 9, 4])}


@pytest.mark.parametrize("case", list(GROUPS))
def test_ragged_dot_gradients_match_jax_grad(case):
    m, sizes = GROUPS[case]
    rng = np.random.default_rng(8)
    lhs = rng.standard_normal((m, 12)).astype(np.float32)
    rhs = rng.standard_normal((E, 12, 20)).astype(np.float32)
    cot = rng.standard_normal((m, 20)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)

    def f(a, b):
        return jnp.sum(jax_grouped_ref(a, b, jnp.asarray(gs)) * cot)

    want_y = np.asarray(jax_grouped_ref(lhs, rhs, jnp.asarray(gs)))
    want_dx, want_dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs),
                                                   jnp.asarray(rhs))
    a = torch.from_numpy(lhs).requires_grad_(True)
    b = torch.from_numpy(rhs).requires_grad_(True)
    y = ragged_dot(a, b, torch.from_numpy(gs))
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(y), want_y, **TOL)
    np.testing.assert_allclose(_np(a.grad), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(_np(b.grad), np.asarray(want_dw), **TOL)


# ----------------------------------------------------------- the MoE clip
@pytest.mark.parametrize("case", ["plain", "nranks2", "experts_only",
                                  "predicate"])
def test_moe_clip_matches_reference(case):
    rng = np.random.default_rng(9)
    shapes = {"w": (4, 3), "experts.0.w": (3, 2), "experts.1.w": (3, 2),
              "b": (5,), "none": (2,)}
    if case == "experts_only":
        shapes = {k: v for k, v in shapes.items() if "experts" in k}
    grads = {n: (rng.standard_normal(s) * 3).astype(np.float32)
             for n, s in shapes.items()}
    kw = {}
    if case == "nranks2":
        kw["moe_group"] = SimpleNamespace(nranks=2)
    jp, tp = [], []
    for n, s in shapes.items():
        j = paddle.framework.Parameter(np.zeros(s, np.float32), name=n)
        t = torch.nn.Parameter(torch.zeros(s))
        if case != "predicate":
            j.is_expert = t.is_expert = "experts" in n
        jp.append(j)
        tp.append(t)
    if case == "predicate":
        ids = {id(p) for p, n in zip(jp + tp, list(shapes) * 2)
               if n.startswith("experts")}
        kw["is_expert_param_func"] = lambda p: id(p) in ids
    jpg = [(p, None if n == "none" else _j(grads[n]))
           for p, n in zip(jp, shapes)]
    tpg = [(p, None if n == "none" else torch.from_numpy(grads[n].copy()))
           for p, n in zip(tp, shapes)]
    want = jmoe.ClipGradForMOEByGlobalNorm(1.0, **kw)(jpg)
    got = tmoe.ClipGradForMOEByGlobalNorm(1.0, **kw)(tpg)
    for (_, g), (_, w) in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(_np(g), np.asarray(w._data),
                                       atol=1e-6)
    assert tmoe.ClipGradForMOEByGlobalNorm(1.0)([(tp[0], None)]) == \
        [(tp[0], None)]


# --------------------------------------------------- training, end to end
class _JBlock(jnn.Layer):
    def __init__(self, path):
        super().__init__()
        self.norm = jnn.LayerNorm(D)
        self.moe = jmoe.MoELayer(
            D, [jmoe.ExpertFFN(D, F, "silu") for _ in range(E)],
            gate=jmoe.GShardGate(D, E, random_routing=False),
            **PATHS[path])

    def forward(self, x):
        return x + self.moe(self.norm(x))


class _TBlock(tnn.Layer):
    def __init__(self, path):
        super().__init__()
        self.norm = tnn.LayerNorm(D, device="cpu")
        self.moe = tmoe.MoELayer(
            D, [tmoe.ExpertFFN(D, F, "silu", device="cpu")
                for _ in range(E)],
            gate=tmoe.GShardGate(D, E, random_routing=False, device="cpu"),
            **PATHS[path])

    def forward(self, x):
        return x + self.moe(self.norm(x))


def _stack_loss(blocks, x, target):
    y = x
    for b in blocks:
        y = b(y)
    d = y - target
    loss = (d * d).mean()
    for b in blocks:
        loss = loss + 0.01 * b.moe.gate.get_loss()
    return loss


@pytest.mark.parametrize("path", list(PATHS))
def test_adamw_steps_of_a_moe_stack_match_reference(path):
    """Two pre-LN MoE blocks, AdamW (lr 1e-2, weight decay 0.01) with
    ``ClipGradForMOEByGlobalNorm(1.0)``, the experts marked ``is_expert``:
    four steps' losses, and the parameters after them, against the JAX
    package's."""
    paddle.seed(0)
    jm = jnn.LayerList([_JBlock(path), _JBlock(path)])
    tm = tnn.LayerList([_TBlock(path), _TBlock(path)])
    w = _weights(jm, 11)
    for n in w:
        if n.endswith("norm.weight"):
            w[n] = 1 + 0.1 * w[n]
    jm.set_state_dict(w)
    assert tm.set_state_dict(w) == ([], [])
    for m in (jm, tm):
        for n, p in m.named_parameters():
            p.is_expert = ".experts." in n
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=jmoe.ClipGradForMOEByGlobalNorm(1.0))
    to = topt.AdamW(learning_rate=1e-2, parameters=list(
        tm.named_parameters()), weight_decay=0.01,
        grad_clip=tmoe.ClipGradForMOEByGlobalNorm(1.0))
    x, target = _x(12, (2, 6, D)), _x(13, (2, 6, D))
    jl, tl = [], []
    for _ in range(4):
        loss = _stack_loss(jm, _j(x), _j(target))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss._data))
        loss = _stack_loss(tm, torch.from_numpy(x), torch.from_numpy(target))
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), want[n], err_msg=n, **TOL)
