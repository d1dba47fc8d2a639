"""The port's functional optimizer API (``init_state_tree`` /
``apply_gradients_tree``) against paddle_tpu's on the same numpy
parameters and gradients, over a nested tree (a dict holding a tensor, a
list and a tuple), for every optimizer the port has:

* three steps of every rule: parameters and state, f32, atol 1e-6 (the
  same arithmetic in another order; Lamb's trust ratio divides two
  norms), with a decay mask on the decoupled and Lamb rules;
* a bf16 parameter under ``multi_precision``: its f32 master in the
  state (atol 1e-6) and the bf16 parameter (exactly, both rounding the
  same f32 master);
* purity: the inputs are not written; a gradient of None counts as
  zeros (the reference's ``jax.grad`` gives zeros for an unused
  parameter);
* the tree step equals the port's own eager ``opt.step()``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt

from paddle_tpu_torch import optimizer as topt
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

RULES = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "Momentum nesterov": dict(learning_rate=0.1, momentum=0.8,
                              use_nesterov=True, weight_decay=0.01),
    "Adam": dict(learning_rate=0.01, weight_decay=0.05),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSProp centered": dict(learning_rate=0.01, centered=True),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01),
}


def _tree(rng):
    """``{"w": [3, 4], "layers": [[5], ([2, 3],)]}`` of numpy arrays."""
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [rng.standard_normal((5,)).astype(np.float32),
                       (rng.standard_normal((2, 3)).astype(np.float32),)]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _flat(tree, prefix=""):
    """``{path: leaf}``, walking dicts and lists / tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _states_flat(state, params):
    """``{path/key: array}`` of a state tree whose leaves (at the params'
    leaves) are dicts of arrays."""
    out = {}
    for path, st in _flat_upto(state, params).items():
        for k, v in st.items():
            out[f"{path}{k}"] = _np(v)
    return out


def _flat_upto(tree, like, prefix=""):
    if isinstance(like, dict):
        out = {}
        for k in like:
            out.update(_flat_upto(tree[k], like[k], f"{prefix}{k}/"))
        return out
    if isinstance(like, (list, tuple)):
        out = {}
        for i in range(len(like)):
            out.update(_flat_upto(tree[i], like[i], f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def _run(rule, bf16, steps=3, mask=None):
    kw = RULES[rule]
    name = rule.split()[0]
    rng = np.random.default_rng(len(rule) + 7 * bf16)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jdt = {"w": jnp.bfloat16} if bf16 else {}
    tdt = {"w": torch.bfloat16} if bf16 else {}

    def jconv(tree):
        return {"w": jnp.asarray(tree["w"], jdt.get("w", jnp.float32)),
                "layers": _map(jnp.asarray, tree["layers"])}

    def tconv(tree):
        return {"w": torch.from_numpy(tree["w"].copy()).to(
                    tdt.get("w", torch.float32)),
                "layers": _map(lambda a: torch.from_numpy(a.copy()),
                               tree["layers"])}

    jo = getattr(jopt, name)(**kw)
    to = getattr(topt, name)(**kw)
    jp, tp = jconv(params), tconv(params)
    js, ts = jo.init_state_tree(jp), to.init_state_tree(tp)
    for i, g in enumerate(grads):
        jg, tg = jconv(g), tconv(g)
        jp, js = jo.apply_gradients_tree(jp, jg, js, kw["learning_rate"],
                                         i + 1, decay_mask_tree=mask)
        tp, ts = to.apply_gradients_tree(tp, tg, ts, kw["learning_rate"],
                                         i + 1, decay_mask_tree=mask)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rule", list(RULES))
def test_apply_gradients_tree_matches_reference(rule, bf16):
    (jp, js), (tp, ts) = _run(rule, bf16)
    want, got = _flat(jp), _flat(tp)
    assert sorted(want) == sorted(got)
    for k in want:
        if bf16 and k == "w/":
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
    ws, gs = _states_flat(js, jp), _states_flat(ts, tp)
    assert sorted(ws) == sorted(gs)
    assert ("w/master" in gs) == bf16
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("rule", ["AdamW", "Lamb", "SGD"])
def test_decay_mask_tree_matches_reference(rule):
    mask = {"w": True, "layers": [False, (True,)]}
    (jp, _), (tp, _) = _run(rule, False, mask=mask)
    want, got = _flat(jp), _flat(tp)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_tree_step_is_pure_and_takes_none_as_zeros():
    rng = np.random.default_rng(3)
    opt = topt.AdamW(learning_rate=0.01, weight_decay=0.1)
    params = {"a": torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    state = opt.init_state_tree(params)
    before = {k: v.clone() for k, v in params.items()}
    state_before = {k: {n: t.clone() for n, t in v.items()}
                    for k, v in state.items()}
    grads = {"a": torch.ones((4, 3), dtype=torch.bfloat16), "b": None}
    new_p, new_s = opt.apply_gradients_tree(params, grads, state, 0.01, 1)
    for k in params:
        assert torch.equal(params[k], before[k])
        for n in state[k]:
            assert torch.equal(state[k][n], state_before[k][n])
    zero = opt.apply_gradients_tree(params, {"a": grads["a"],
                                             "b": torch.zeros(5)},
                                    state, 0.01, 1)
    for k in params:
        assert torch.equal(new_p[k], zero[0][k])
    assert new_p["a"].dtype == torch.bfloat16
    assert new_s["a"]["master"].dtype == torch.float32
    # an unused parameter still decays (AdamW) and its moments stay zero
    assert not torch.equal(new_p["b"], params["b"])
    assert not new_s["b"]["moment1"].any()
    jo = jopt.AdamW(learning_rate=0.01, weight_decay=0.1)
    jb = jnp.asarray(before["b"].numpy())
    jnew, _ = jo.apply_gradients_tree(
        {"b": jb}, jax.tree_util.tree_map(jnp.zeros_like, {"b": jb}),
        jo.init_state_tree({"b": jb}), 0.01, 1)
    np.testing.assert_allclose(new_p["b"].numpy(), np.asarray(jnew["b"]),
                               atol=1e-7)


@pytest.mark.parametrize("rule", ["AdamW", "Momentum", "Lamb"])
def test_tree_step_equals_eager_step(rule):
    """Three tree steps give the parameters three eager ``opt.step()``s
    give, on a flat dict of f32 and bf16 parameters."""
    kw = RULES[rule]
    cls = getattr(topt, rule)
    rng = np.random.default_rng(11)
    init = {"x": rng.standard_normal((6, 2)).astype(np.float32),
            "y": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    dts = {"x": torch.bfloat16, "y": torch.float32}
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dts[k]))
          for k, v in init.items()}
    eager = cls(parameters=list(ps.items()), **kw)
    tree = cls(**kw)
    tp = {k: p.detach().clone() for k, p in ps.items()}
    ts = tree.init_state_tree(tp)
    for i, g in enumerate(grads):
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k]).to(dts[k])
        eager.step()
        eager.clear_grad()
        tp, ts = tree.apply_gradients_tree(
            tp, {k: torch.from_numpy(v).to(dts[k]) for k, v in g.items()},
            ts, kw["learning_rate"], i + 1)
    for k in ps:
        torch.testing.assert_close(tp[k], ps[k].detach(), atol=1e-6,
                                   rtol=0)
