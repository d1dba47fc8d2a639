"""Expert-parallel MoE training in the port (``MoELayer`` at ep = 2) in one
world of two gloo processes, against the JAX package's ``MoELayer`` on the
global batch: the reference's answer at ep > 1 is its global program, the
same layer without a mesh on every rank's tokens, rank-major
(``tests/test_moe.py::test_ep_sharding_on_mesh``). The reference runs here
without a mesh (outputs, aux loss, gradients) and under
``set_mesh(build_mesh(dp=2))``, its experts sharded over ``dp`` (outputs
and aux loss); both are held to each other and to the port.

Each rank keeps experts ``[r·E/2, (r+1)·E/2)`` under their global names,
fills only its own slots of ``[E, C, H]`` (the capacity and the slot order
the global ones), all-to-alls them to their owners and all-gathers the
experts' rows back. Tolerances (f32, the same arithmetic summed in another
order):

* outputs 1e-5, the aux loss 1e-6, the dropped pairs exact (rank-major
  against the reference's dispatch on the global batch);
* gradients of the experts, the gate and the LayerNorm after the fleet
  optimizer's sync (experts divided by ep, the rest dp-averaged) 1e-5;
* four AdamW steps of a two-block MoE stack with
  ``ClipGradForMOEByGlobalNorm``: the mean of the ranks' losses within 1e-5
  relative of the reference's, parameters within 1e-5;
* the ep = 2 checkpoint loaded at ep = 1 (parameters bitwise, the next
  AdamW step 1e-5), and an ep = 1 checkpoint loaded at ep = 2 (1e-5);
* random routing and the Switch jitter by rule (each rank draws the
  global batch's rows and takes its own), and equal to the port's ep = 1
  layer on the global batch with the same generator (1e-5).

A per-rank capacity over per-rank counts (upstream ``global_scatter``'s
order) drops other pairs on the same inputs, so the drop check can fail.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD = 2
D, F, E = 8, 16, 4
T = 12                       # tokens a rank: the global batch is 2 x 12
TOL = dict(atol=1e-5, rtol=1e-5)
GATE_CASES = [(g, cf) for g in ("naive2", "gshard", "switch")
              for cf in (4.0, 0.5)]
STEPS, SAVE_AT = 4, 3


@pytest.fixture(autouse=True, scope="module")
def no_jax_mesh():
    """The JAX layers run "without a mesh" on the JAX package's default
    mesh, as in a fresh process, whatever mesh an earlier test's
    ``fleet.init`` left in this worker (set up before the module's
    reference fixtures)."""
    from paddle_tpu.distributed import parallel as jparallel

    prev = jparallel._global_mesh
    jparallel.set_mesh(None)
    yield
    jparallel.set_mesh(prev)


def _gate(m, name, **kw):
    if name == "naive2":
        return m.NaiveGate(D, E, topk=2, **kw)
    if name == "gshard":
        return m.GShardGate(D, E, random_routing=False, **kw)
    return m.SwitchGate(D, E, switch_eps=0.0, **kw)


def _tblock(gate, cf=None, experts=E, **kw):
    """LayerNorm -> MoELayer -> residual on the port (``gate`` a GATES key
    or a port gate)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    class Block(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = tnn.LayerNorm(D, device="cpu")
            g = _gate(tmoe, gate, device="cpu") if isinstance(gate, str) \
                else gate
            self.moe = tmoe.MoELayer(
                D, [tmoe.ExpertFFN(D, F, "silu", device="cpu")
                    for _ in range(experts)], gate=g, capacity_factor=cf,
                **kw)

        def forward(self, x):
            return x + self.moe(self.norm(x))

    return Block()


def _tstack():
    from paddle_tpu_torch import nn as tnn

    return tnn.LayerList([_tblock("gshard"), _tblock("gshard")])


def _weights(model, seed):
    r = np.random.default_rng(seed)
    out = {}
    for n, p in model.named_parameters():
        v = 0.5 * r.standard_normal(tuple(p.shape))
        if n.endswith("norm.weight"):
            v = 1 + 0.2 * v
        out[n] = v.astype(np.float32)
    return out


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stack_loss(blocks, x, target):
    y = x
    for b in blocks:
        y = b(y)
    d = y - target
    loss = (d * d).mean()
    for b in blocks:
        loss = loss + 0.01 * b.moe.gate.get_loss()
    return loss


# ------------------------------------------------------------ the ranks
def _grad_case(rank, gate, cf, data):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.distributed import fleet

    blk = _tblock(gate, cf).train()
    moe_from_numpy(blk, data["block_w"])
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=0.0, parameters=list(blk.named_parameters())))
    x = torch.from_numpy(data["x"][rank * T:(rank + 1) * T])
    y = blk(x)
    aux = blk.moe.gate.get_loss()
    loss = (y * y).mean() + (0.01 * aux if aux is not None else 0.0)
    loss.backward()
    opt._sync_dp_grads()
    return dict(y=y.detach().numpy(),
                aux=None if aux is None else float(aux.detach()),
                drops=blk.moe.last_drops.numpy(),
                names=sorted(n for n, _ in blk.named_parameters()),
                marked=sorted(n for n, p in blk.named_parameters()
                              if getattr(p, "is_expert", False)),
                grads={n: p.grad.numpy().copy()
                       for n, p in blk.named_parameters()})


def _adamw_case(rank, data, out_dir):
    """Four steps through fleet (rank 1's replicated weights perturbed: the
    wrap's broadcast must restore them and leave the experts alone); the
    model and optimizer saved by both ranks after step SAVE_AT."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.distributed import fleet, get_group, \
        save_state_dict
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    model = _tstack().train()
    moe_from_numpy(model, data["stack_w"])
    experts0 = {n: p.detach().clone() for n, p in model.named_parameters()
                if ".experts." in n}
    if rank == 1:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if ".experts." not in n:
                    p.add_(1.0)
    model = fleet.distributed_model(model)
    kept = all(torch.equal(p, experts0[n]) for n, p in
               model.named_parameters() if n in experts0)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-2, parameters=list(model.named_parameters()),
        weight_decay=0.01,
        grad_clip=tmoe.ClipGradForMOEByGlobalNorm(1.0)))
    rows = slice(rank * 2, (rank + 1) * 2)
    x = torch.from_numpy(data["sx"][rows])
    target = torch.from_numpy(data["st"][rows])
    losses = []
    for step in range(1, STEPS + 1):
        loss = _stack_loss(model, x, target)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        if step == SAVE_AT:
            state = {f"model.{k}": v for k, v in model.state_dict().items()}
            state.update({f"opt.{k}": v for k, v in
                          opt.state_dict().items()})
            save_state_dict(state, os.path.join(out_dir, "ckpt_ep2"),
                            group=get_group())
    return dict(losses=losses, experts_kept=kept,
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()})


def _captured(layer):
    got = []
    layer.gate.register_forward_hook(
        lambda mod, inp, out: got.append((inp[0].detach(), out[0].detach(),
                                          out[1])))
    return got


def _rule_case(rank, data):
    """Random routing and the Switch jitter at ep = 2: the gate's draws,
    and the layer's output for the port's ep = 1 comparison."""
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    x = torch.from_numpy(data["x"][rank * T:(rank + 1) * T])
    out = {}
    for name, gate in (
            ("gshard", tmoe.GShardGate(D, E, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(5))),
            ("switch", tmoe.SwitchGate(D, E, switch_eps=0.1, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(7)))):
        blk = _tblock(gate, 4.0).train()
        moe_from_numpy(blk, data["block_w"])
        got = _captured(blk.moe)
        y = blk(x).detach()
        inp, val, idx = got[0]
        if name == "gshard":
            gate.random_routing = False
            val0, idx0 = gate(inp)
            r = torch.rand(WORLD * T, generator=torch.Generator()
                           .manual_seed(5))[rank * T:(rank + 1) * T]
            want = torch.where(2 * val0[:, 1] < r, -1, idx0[:, 1])
            ok = (torch.equal(val, val0) and torch.equal(idx[:, 0],
                                                         idx0[:, 0])
                  and torch.equal(idx[:, 1], want))
            out[name] = dict(y=y.numpy(), rule=ok,
                             dropped=int((idx[:, 1] == -1).sum()))
        else:
            noise = torch.empty((WORLD * T, E)).uniform_(
                0.9, 1.1, generator=torch.Generator().manual_seed(7))[
                rank * T:(rank + 1) * T]
            wv, wi = torch.topk(torch.softmax(gate.gate(inp) * noise, -1), 1)
            out[name] = dict(y=y.numpy(), rule=torch.equal(idx, wi)
                             and torch.equal(val, wv))
    return out


def _refusals(rank, data):
    from paddle_tpu_torch.distributed import parallel

    out = {}
    x = torch.from_numpy(data["x"][rank * T:(rank + 1) * T])
    for kw in (dict(use_ragged=True), dict(dropless=True)):
        blk = _tblock("gshard", 2.0, **kw)
        try:
            blk(x)
            out[str(kw)] = None
        except ValueError as e:
            out[str(kw)] = str(e)
    try:
        _tblock("gshard", 2.0, experts=3)
        out["E=3"] = None
    except ValueError as e:
        out["E=3"] = str(e)
    blk = _tblock("gshard", 2.0)
    prev = parallel._global_mesh
    parallel.set_mesh(SimpleNamespace(mesh_dim_names=(
        "dp", "pp", "sharding", "sep", "mp"), shape=(1, 1, 1, 1, 2)))
    try:
        blk(x)
        out["mesh"] = None
    except TypeError as e:
        out["mesh"] = str(e)
    finally:
        parallel.set_mesh(prev)
    return out


def _from_ep1_checkpoint(rank, data, ckpt):
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.distributed import load_state_dict

    state = load_state_dict(ckpt)
    model = _tstack().eval()
    moe_from_numpy(model, {k[6:]: v for k, v in state.items()
                           if k.startswith("model.")})
    x = torch.from_numpy(data["sx"][rank * 2:(rank + 1) * 2])
    with torch.no_grad():
        y = x
        for b in model:
            y = b(y)
    return y.numpy()


def _worker(rank, world, init_file, out_dir, data_file, ckpt_ep1):
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch.distributed import destroy_process_group, fleet

    fleet.init(is_collective=True, device="cpu")
    data = torch.load(data_file, weights_only=False)
    res = {case: _grad_case(rank, *case, data) for case in GATE_CASES}
    res["adamw"] = _adamw_case(rank, data, out_dir)
    res["rules"] = _rule_case(rank, data)
    res["refusals"] = _refusals(rank, data)
    res["from_ep1"] = _from_ep1_checkpoint(rank, data, ckpt_ep1)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    destroy_process_group()


@pytest.fixture(scope="module")
def data():
    block_w = _weights(_tblock("gshard"), 0)
    stack_w = _weights(_tstack(), 11)
    return dict(block_w=block_w, stack_w=stack_w,
                x=_x(1, (WORLD * T, D)), sx=_x(12, (4, 6, D)),
                st=_x(13, (4, 6, D)), ckpt_w=_weights(_tstack(), 21))


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.distributed import save_state_dict

    tmp = tmp_path_factory.mktemp("moe_ep_world")
    torch.save(data, tmp / "data.pt")
    ep1 = moe_from_numpy(_tstack(), data["ckpt_w"])
    save_state_dict({f"model.{k}": v for k, v in ep1.state_dict().items()},
                    str(tmp / "ckpt_ep1"))
    ranks = W.run_world(_worker, WORLD, tmp, str(tmp / "data.pt"),
                        str(tmp / "ckpt_ep1"))
    return SimpleNamespace(ranks=ranks, dir=tmp)


# ------------------------------------------------------- the JAX side
def _jax():
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.incubate.distributed.models import moe as jmoe

    return paddle, jnn, jmoe


def _jblock(gate, cf=None):
    _, jnn, jmoe = _jax()

    class Block(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = jnn.LayerNorm(D)
            self.moe = jmoe.MoELayer(
                D, [jmoe.ExpertFFN(D, F, "silu") for _ in range(E)],
                gate=_gate(jmoe, gate), capacity_factor=cf,
                use_ragged=False)

        def forward(self, x):
            return x + self.moe(self.norm(x))

    return Block()


def _set(layer, w):
    import jax.numpy as jnp

    for n, p in layer.named_parameters():
        p.set_value(jnp.asarray(w[n]))
    return layer


def _jax_grads(blk, x):
    paddle, _, _ = _jax()
    for p in blk.parameters():
        p.grad = None
    out = blk(paddle.to_tensor(x))
    aux = blk.moe.gate.get_loss()
    loss = (out * out).mean()
    if aux is not None:
        loss = loss + 0.01 * aux.mean()
    loss.backward()
    return dict(y=np.asarray(out._data),
                aux=None if aux is None else float(aux._data),
                grads={n: np.asarray(p.grad._data)
                       for n, p in blk.named_parameters()})


_REFERENCE = {}


def _reference(data, case):
    """The JAX layer of ``case`` on the global batch: outputs, aux loss and
    gradients without a mesh, and outputs and aux loss under
    ``set_mesh(build_mesh(dp=2))`` (its experts sharded over dp). Made on
    first use in this worker and kept."""
    from paddle_tpu.distributed.parallel import set_mesh
    from paddle_tpu.distributed.topology import build_mesh

    if case not in _REFERENCE:
        paddle, _, _ = _jax()
        paddle.seed(0)
        blk = _set(_jblock(*case), data["block_w"]).train()
        plain = _jax_grads(blk, data["x"])
        set_mesh(build_mesh(dp=2))
        try:
            y = blk(paddle.to_tensor(data["x"]))
            aux = blk.moe.gate.get_loss()
        finally:
            set_mesh(None)
        meshed = dict(y=np.asarray(y._data),
                      aux=None if aux is None else float(aux._data))
        _REFERENCE[case] = (plain, meshed)
    return _REFERENCE[case]


def _global(ranks, key):
    return np.concatenate([r[key[0]][key[1]] for r in ranks])


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("case", GATE_CASES,
                         ids=[f"{g}-{'generous' if cf > 1 else 'drops'}"
                              for g, cf in GATE_CASES])
def test_ep2_forward_and_aux_match_reference(world, data, case):
    plain, meshed = _reference(data, case)
    np.testing.assert_allclose(meshed["y"], plain["y"], **TOL)
    got = _global(world.ranks, (case, "y"))
    for want in (plain, meshed):
        np.testing.assert_allclose(got, want["y"], **TOL)
    for r in world.ranks:
        if case[0] == "naive2":
            assert r[case]["aux"] is None and plain["aux"] is None
        else:
            np.testing.assert_allclose(r[case]["aux"], plain["aux"],
                                       atol=1e-6)
            np.testing.assert_allclose(r[case]["aux"], meshed["aux"],
                                       atol=1e-6)


def _reference_drops(data, case):
    """The pairs the reference drops on the global batch: routed (expert
    >= 0) but dispatched nowhere by ``gshard_dispatch``."""
    import jax.numpy as jnp

    paddle, _, jmoe = _jax()
    paddle.seed(0)
    blk = _set(_jblock(*case), data["block_w"]).train()
    h = blk.norm(paddle.to_tensor(data["x"]))
    val, idx = blk.moe.gate(h)[:2]
    idx = np.asarray(idx._data)
    cap = blk.moe._capacity(idx.shape[0])
    dispatch, _ = jmoe.gshard_dispatch(val, jnp.asarray(idx), E, cap)
    routed = np.take_along_axis(np.asarray(dispatch).sum(-1), idx, 1) > 0
    return (idx >= 0) & ~routed, np.asarray(val._data), idx, cap


@pytest.mark.parametrize("case", GATE_CASES,
                         ids=[f"{g}-{'generous' if cf > 1 else 'drops'}"
                              for g, cf in GATE_CASES])
def test_ep2_drops_are_the_global_capacity_order(world, data, case):
    want = _reference_drops(data, case)[0]
    got = _global(world.ranks, (case, "drops"))
    np.testing.assert_array_equal(got, want)
    assert want.any() == (case[1] < 1), int(want.sum())


def test_per_rank_capacity_would_drop_other_pairs(data):
    """On the same routing, upstream's order (each rank's own capacity over
    its own counts) keeps other pairs than the global order, which the
    ep = 2 layer keeps (the test above)."""
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    for case in GATE_CASES:
        if case[1] > 1:
            continue
        want, val, idx, cap = _reference_drops(data, case)
        t_val = torch.from_numpy(val.copy())
        t_idx = torch.from_numpy(idx.copy())
        per_rank = []
        for r in range(WORLD):
            rows = slice(r * T, (r + 1) * T)
            disp, _ = tmoe.gshard_dispatch(t_val[rows], t_idx[rows], E,
                                           max(1, int(0.5 * idx.shape[1] * T
                                                      / E)))
            routed = torch.gather(disp.sum(-1), 1, t_idx[rows].clamp(min=0))
            per_rank.append(((t_idx[rows] >= 0) & (routed == 0)).numpy())
        assert not np.array_equal(np.concatenate(per_rank), want), case


@pytest.mark.parametrize("case", GATE_CASES,
                         ids=[f"{g}-{'generous' if cf > 1 else 'drops'}"
                              for g, cf in GATE_CASES])
def test_ep2_gradients_after_the_fleet_sync_match_reference(world, data,
                                                            case):
    plain = _reference(data, case)[0]
    per = E // WORLD
    names = set()
    for rank, r in enumerate(world.ranks):
        res = r[case]
        mine = {f"moe.experts.{e}." for e in range(rank * per,
                                                   (rank + 1) * per)}
        experts = [n for n in res["names"] if ".experts." in n]
        assert {n[:len("moe.experts.0.")] for n in experts} == mine
        assert res["marked"] == sorted(experts)
        names |= set(res["names"])
        for n, g in res["grads"].items():
            np.testing.assert_allclose(g, plain["grads"][n], err_msg=n,
                                       **TOL)
    assert names == set(plain["grads"])
    assert any(n.startswith("moe.gate.") for n in names)
    assert any(n.startswith("norm.") for n in names)


def _jstack(w):
    _, jnn, _ = _jax()
    m = jnn.LayerList([_jblock("gshard"), _jblock("gshard")])
    return _set(m, w)


@pytest.fixture(scope="module")
def jax_adamw(data):
    """The reference's four AdamW steps (lr 1e-2, weight decay 0.01,
    ``ClipGradForMOEByGlobalNorm(1.0)``, the experts marked ``is_expert``)
    of the two-block stack on the global batch."""
    import jax.numpy as jnp

    paddle, _, jmoe = _jax()
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.framework.tensor import Tensor

    paddle.seed(0)
    jm = _jstack(data["stack_w"])
    for n, p in jm.named_parameters():
        p.is_expert = ".experts." in n
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                    weight_decay=0.01,
                    grad_clip=jmoe.ClipGradForMOEByGlobalNorm(1.0))
    x = Tensor._wrap(jnp.asarray(data["sx"]))
    t = Tensor._wrap(jnp.asarray(data["st"]))
    losses = []
    for _ in range(STEPS):
        loss = _stack_loss(jm, x, t)
        loss.backward()
        jo.step()
        jo.clear_grad()
        losses.append(float(loss._data))
    return losses, {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def test_adamw_steps_of_a_moe_stack_at_ep2_match_reference(world, jax_adamw):
    want_losses, want = jax_adamw
    a = [r["adamw"] for r in world.ranks]
    assert all(r["experts_kept"] for r in a)
    np.testing.assert_allclose(np.mean([r["losses"] for r in a], 0),
                               want_losses, rtol=1e-5)
    assert want_losses[-1] < want_losses[0]
    seen = set()
    for r in a:
        for n, p in r["params"].items():
            np.testing.assert_allclose(p, want[n], err_msg=n, **TOL)
            if ".experts." not in n:  # replicated: equal on both ranks
                np.testing.assert_array_equal(p, a[0]["params"][n])
            seen.add(n)
    assert seen == set(want)


def test_ep2_checkpoint_loads_at_ep1_and_steps_on(world, data):
    """The two ranks' checkpoint (each its experts under their global
    names) loads whole into one process at ep = 1; AdamW from its state
    takes step 4 to the ranks' step 4."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import load_state_dict
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    state = load_state_dict(str(world.dir / "ckpt_ep2"))
    model = _tstack().train()
    model.load_state_dict({k[6:]: v for k, v in state.items()
                           if k.startswith("model.")}, strict=True)
    opt = optimizer.AdamW(learning_rate=1e-2,
                          parameters=list(model.named_parameters()),
                          weight_decay=0.01,
                          grad_clip=tmoe.ClipGradForMOEByGlobalNorm(1.0))
    opt.set_state_dict({k[4:]: v for k, v in state.items()
                        if k.startswith("opt.")})
    for n, p in model.named_parameters():
        p.is_expert = ".experts." in n
    assert opt._step_count == SAVE_AT
    loss = _stack_loss(model, torch.from_numpy(data["sx"]),
                       torch.from_numpy(data["st"]))
    loss.backward()
    opt.step()
    after = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for r in world.ranks:
        for n, p in r["adamw"]["params"].items():
            np.testing.assert_allclose(after[n], p, err_msg=n, **TOL)


def test_ep1_checkpoint_loads_at_ep2(world, data):
    from paddle_tpu_torch.convert import moe_from_numpy

    model = moe_from_numpy(_tstack(), data["ckpt_w"]).eval()
    with torch.no_grad():
        y = torch.from_numpy(data["sx"])
        for b in model:
            y = b(y)
    got = np.concatenate([r["from_ep1"] for r in world.ranks])
    np.testing.assert_allclose(got, y.numpy(), **TOL)


def test_random_draws_at_ep2_follow_the_rules(world, data):
    """Each rank's second-choice drops and Switch jitter are the rule's on
    its rows of the global draw; the layer then equals the port's ep = 1
    layer on the global batch with the same generator."""
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.incubate.distributed.models import moe as tmoe

    for name, seed in (("gshard", 5), ("switch", 7)):
        assert all(r["rules"][name]["rule"] for r in world.ranks), name
        if name == "gshard":
            assert sum(r["rules"][name]["dropped"] for r in world.ranks) > 0
        gate = (tmoe.GShardGate(D, E, device="cpu") if name == "gshard"
                else tmoe.SwitchGate(D, E, switch_eps=0.1, device="cpu"))
        gate.generator = torch.Generator().manual_seed(seed)
        blk = moe_from_numpy(_tblock(gate, 4.0, use_ragged=False),
                             data["block_w"]).train()
        with torch.no_grad():
            want = blk(torch.from_numpy(data["x"])).numpy()
        got = np.concatenate([r["rules"][name]["y"] for r in world.ranks])
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_ep2_refusals(world):
    """As the reference: ``use_ragged=True`` and ``dropless=True`` raise
    at ep > 1. Where the reference falls back to replicated experts (E not
    divisible by ep) the port raises; a forward on another mesh raises."""
    for r in world.ranks:
        f = r["refusals"]
        for kw in ("{'use_ragged': True}", "{'dropless': True}"):
            assert f[kw] is not None and "expert-parallel" in f[kw], kw
        assert f["E=3"] is not None and "divide" in f["E=3"]
        assert f["mesh"] is not None and "expert parallelism 2" in f["mesh"]
