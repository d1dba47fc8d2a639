"""The port's tensor-parallel layer library (``distributed/fleet/
meta_parallel``: ``mp_layers``, ``random``, ``tensor_parallel``),
``fleet.distributed_model`` and the collectives, in one world of four
gloo processes laid out by ``fleet.init`` as ``mp=2`` (``dp=2`` inferred:
ranks 0-1 and 2-3 are the mp groups).

Each rank holds its shard of the same full weights (seeded numpy); the
layers' outputs and the gradients of ``sum(out * ct)`` (the input's, and
each rank's parameter shards concatenated back) are held against
paddle_tpu's layers given the full weights (its eager tape), within 1e-5.
``ParallelCrossEntropy`` is held against the reference's vocab-parallel
kernel (``parallel_cross_entropy_shardmap`` under ``shard_map`` over two
devices of the 8-device CPU mesh, ``jax.grad`` for the logits' gradient),
with ``ignore_index`` rows giving 0 and no gradient. The RNG tracker:
named states and the duplicate guard, draws that differ across mp ranks
inside ``rng_state`` and agree across dp replicas and outside it. The new
collectives and the autograd forms against numpy.
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD, MP = 4, 2
IN, OUT, V, H, B, S = 8, 12, 16, 8, 2, 3
TOL = dict(rtol=1e-5, atol=1e-5)
IGNORE = -100


def _arrays():
    r = np.random.default_rng(0)

    def a(*shape):
        return r.standard_normal(shape).astype(np.float32)

    labels = r.integers(0, V, (B, S))
    labels[0, 1] = IGNORE
    return dict(x=a(B, S, IN), ct_out=a(B, S, OUT), ct_h=a(B, S, H),
                col_w=a(IN, OUT), col_b=a(OUT), row_w=a(OUT, H), row_b=a(H),
                emb_w=a(V, H), ids=r.integers(0, V, (B, S)),
                logits=a(B * S, V), labels=labels.reshape(-1),
                ct_loss=a(B * S))


def _grad_run(layer, x, ct):
    """(out, input grad or None, {name: grad}) of ``sum(layer(x) * ct)``."""
    for p in layer.parameters():
        p.grad = None
    xt = x.clone().requires_grad_(x.is_floating_point())
    out = layer(xt)
    (out * ct).sum().backward()
    return (out.detach().numpy(),
            None if xt.grad is None else xt.grad.numpy(),
            {n: p.grad.numpy().copy() for n, p in layer.named_parameters()})


def _layers(a, hcg):
    from paddle_tpu_torch.distributed.fleet import meta_parallel as M

    g = hcg.get_model_parallel_group()
    r = g.rank
    out = {}
    x = torch.from_numpy(a["x"])

    def load(layer, **full):
        with torch.no_grad():
            for name, arr in full.items():
                p = getattr(layer, name)
                idx = M.shard_slices(arr.shape, getattr(p, "dist_spec", None),
                                     {"mp": (r, MP)})
                p.copy_(torch.from_numpy(arr[idx]))
        return layer

    for gather in (True, False):
        col = load(M.ColumnParallelLinear(IN, OUT, gather_output=gather,
                                          device="cpu"),
                   weight=a["col_w"], bias=a["col_b"])
        ct = torch.from_numpy(a["ct_out"])
        if not gather:
            ct = ct.chunk(MP, dim=-1)[r]
        out[f"col_gather{int(gather)}"] = _grad_run(col, x, ct)
    for parallel in (False, True):
        row = load(M.RowParallelLinear(OUT, H, input_is_parallel=parallel,
                                       device="cpu"),
                   weight=a["row_w"], bias=a["row_b"])
        xin = torch.from_numpy(a["ct_out"])  # a [B, S, OUT] input
        if parallel:
            xin = xin.chunk(MP, dim=-1)[r]
        out[f"row_parallel{int(parallel)}"] = _grad_run(
            row, xin, torch.from_numpy(a["ct_h"]))
    emb = load(M.VocabParallelEmbedding(V, H, device="cpu"),
               weight=a["emb_w"])
    out["emb"] = _grad_run(emb, torch.from_numpy(a["ids"]),
                           torch.from_numpy(a["ct_h"]))
    logits = torch.from_numpy(a["logits"]).chunk(MP, dim=-1)[r]
    logits = logits.clone().requires_grad_(True)
    pce = M.ParallelCrossEntropy(ignore_index=IGNORE)
    loss = pce(logits, torch.from_numpy(a["labels"])[:, None])
    (loss * torch.from_numpy(a["ct_loss"])).sum().backward()
    out["pce"] = (loss.detach().numpy(), logits.grad.numpy())
    return out


def _rng(hcg):
    from paddle_tpu_torch.distributed.fleet import meta_parallel as M
    from paddle_tpu_torch.framework import random as R

    M.model_parallel_random_seed(7)
    tracker = M.get_rng_state_tracker()
    out = {"global": torch.rand(4, generator=R.next_generator()).numpy()}
    with tracker.rng_state():
        out["mp"] = torch.rand(4, generator=R.next_generator()).numpy()
    out["global_after"] = torch.rand(
        4, generator=R.next_generator()).numpy()
    errs = []
    for fn in (lambda: tracker.add("model_parallel_rng", 99),
               lambda: tracker.add("other", 7 + 1024),
               lambda: tracker.rng_state("missing").__enter__()):
        try:
            fn()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    out["mp_rank"] = hcg.get_model_parallel_rank()
    return out


class _Net(torch.nn.Module):
    """A column-row pair (mp-split) between replicated parameters, with a
    full-size Linear annotated by hand (``apply_dist_specs`` slices it)."""

    def __init__(self):
        from paddle_tpu_torch.distributed.fleet import meta_parallel as M

        super().__init__()
        torch.manual_seed(1000 + torch.distributed.get_rank())
        self.col = M.ColumnParallelLinear(IN, OUT, gather_output=False,
                                          device="cpu")
        self.row = M.RowParallelLinear(OUT, H, input_is_parallel=True,
                                       device="cpu")
        self.scale = torch.nn.Parameter(torch.rand(H))
        self.head = torch.nn.Linear(H, 6, bias=False)
        self.head.weight.dist_spec = ("mp", None)  # [6, H]: rows split
        self.head.weight.is_distributed = True
        with torch.no_grad():
            for p in (self.col.weight, self.row.weight, self.row.bias):
                p.copy_(torch.rand(p.shape))
            self.head.weight.copy_(torch.arange(6 * H, dtype=torch.float32)
                                   .reshape(6, H))

    def forward(self, x):
        return self.row(self.col(x)) * self.scale


def _distributed_model(hcg):
    from paddle_tpu_torch.distributed import fleet

    net = _Net()
    wrapped = fleet.distributed_model(net)
    x = torch.from_numpy(np.ones((2, IN), np.float32))
    wrapped(x).sum().backward()
    before = net.scale.grad.clone()
    wrapped.apply_collective_grads()
    return dict(type=type(wrapped).__name__,
                scale=net.scale.detach().numpy().copy(),
                row_bias=net.row.bias.detach().numpy().copy(),
                head=net.head.weight.detach().numpy().copy(),
                col_shape=tuple(net.col.weight.shape),
                grad_before=before.numpy(),
                grad_after=net.scale.grad.numpy().copy())


def _collectives(rank):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.communication import stream

    out = {}
    t = torch.tensor([float(rank)] * 2)
    C.broadcast(t, 2)
    out["broadcast"] = t.tolist()
    t = torch.tensor([float(rank + 1)])
    C.reduce(t, 0)
    out["reduce"] = t.tolist()
    t = torch.zeros(2)
    C.scatter(t, [torch.tensor([10.0 * j, 10.0 * j + 1]) for j in range(4)]
              if rank == 1 else None, src=1)
    out["scatter"] = t.tolist()
    t = torch.zeros(1)
    C.reduce_scatter(t, [torch.tensor([float(rank * 4 + j)])
                         for j in range(4)])
    out["reduce_scatter"] = t.tolist()
    out["objects"] = C.all_gather_object([], {"rank": rank, "s": "x" * rank})
    task = stream.all_reduce(torch.ones(1))
    out["task"] = (task.wait(), task.is_completed())
    # the autograd forms: forward values and input gradients of
    # sum(f(x) * w) for a fixed per-rank weight w
    x0 = torch.arange(4, dtype=torch.float32) + 10 * rank
    for name, fn in (
            ("f_all_reduce", lambda x: C.fcollectives.all_reduce(x)),
            ("f_all_gather", lambda x: C.fcollectives.all_gather(x)),
            ("f_reduce_scatter",
             lambda x: C.fcollectives.reduce_scatter(x)),
            ("f_all_to_all", lambda x: C.fcollectives.all_to_all(x))):
        x = x0.clone().requires_grad_(True)
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32) + rank
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    out["axis_index"] = C.fcollectives.axis_index()
    return out


def _worker(rank, world, init_file, out_dir, arrays_file):
    from paddle_tpu_torch.distributed import fleet

    W.init_world(rank, world, init_file)
    a = dict(np.load(arrays_file))
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"mp_degree": MP}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    res = dict(layers=_layers(a, hcg), rng=_rng(hcg),
               dm=_distributed_model(hcg), coll=_collectives(rank),
               mp_rank=hcg.get_model_parallel_rank())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_world")
    np.savez(tmp / "arrays.npz", **arrays)
    return W.run_world(_worker, WORLD, tmp, str(tmp / "arrays.npz"))


# ------------------------------------------------------- the JAX side
def _jax_layer_grads(layer, x, ct, grad_x=True):
    import paddle_tpu as paddle

    for p in layer.parameters():
        p.grad = None
    xt = paddle.to_tensor(x, stop_gradient=not grad_x)
    out = layer(xt)
    (out * paddle.to_tensor(ct)).sum().backward()
    return (np.asarray(out._data),
            np.asarray(xt.grad._data) if grad_x else None,
            {n: np.asarray(p.grad._data)
             for n, p in layer.named_parameters()})


def _set(layer, **full):
    import jax.numpy as jnp

    for name, arr in full.items():
        getattr(layer, name).set_value(jnp.asarray(arr))
    return layer


def _jax_layers(a):
    from paddle_tpu.distributed.fleet import meta_parallel as JM

    col = _set(JM.ColumnParallelLinear(IN, OUT), weight=a["col_w"],
               bias=a["col_b"])
    row = _set(JM.RowParallelLinear(OUT, H), weight=a["row_w"],
               bias=a["row_b"])
    emb = _set(JM.VocabParallelEmbedding(V, H), weight=a["emb_w"])
    return dict(col=_jax_layer_grads(col, a["x"], a["ct_out"]),
                row=_jax_layer_grads(row, a["ct_out"], a["ct_h"]),
                emb=_jax_layer_grads(emb, a["ids"], a["ct_h"],
                                     grad_x=False))


def _jax_pce(a):
    """The reference's vocab-parallel kernel over two devices, its
    ``ignore_index`` rule, and ``jax.grad`` for the logits."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.fleet.meta_parallel import \
        parallel_cross_entropy_shardmap
    from paddle_tpu.distributed.jax_compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:MP]), ("mp",))
    kernel = shard_map(
        lambda lg, lb: parallel_cross_entropy_shardmap(lg, lb, "mp"), mesh,
        in_specs=(P(None, "mp"), P(None)), out_specs=P(None))
    labels = jnp.asarray(a["labels"], jnp.int32)

    def loss(lg):
        per = kernel(lg, labels)
        return jnp.where(labels == IGNORE, 0.0, per)

    lg = jnp.asarray(a["logits"])
    ct = jnp.asarray(a["ct_loss"])
    value = loss(lg)
    grad = jax.grad(lambda g: jnp.sum(loss(g) * ct))(lg)
    return np.asarray(value), np.asarray(grad)


@pytest.fixture(scope="module")
def jax_ref(arrays):
    return dict(_jax_layers(arrays), pce=_jax_pce(arrays))


def _mp_pairs(ranks):
    """[(mp rank 0's results, mp rank 1's)] for each dp replica."""
    return [(ranks[0], ranks[1]), (ranks[2], ranks[3])]


def _cat(pair, key, name, dim):
    return np.concatenate([p["layers"][key][2][name] for p in pair], dim)


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(ranks, jax_ref, gather):
    out, gx, g = jax_ref["col"]
    key = f"col_gather{int(gather)}"
    for pair in _mp_pairs(ranks):
        for r, res in enumerate(pair):
            o, ox, _ = res["layers"][key]
            want = out if gather else np.split(out, MP, axis=-1)[r]
            np.testing.assert_allclose(o, want, **TOL)
            np.testing.assert_allclose(ox, gx, **TOL)
        np.testing.assert_allclose(_cat(pair, key, "weight", 1),
                                   g["weight"], **TOL)
        np.testing.assert_allclose(_cat(pair, key, "bias", 0), g["bias"],
                                   **TOL)


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear(ranks, jax_ref, parallel):
    out, gx, g = jax_ref["row"]
    key = f"row_parallel{int(parallel)}"
    for pair in _mp_pairs(ranks):
        for r, res in enumerate(pair):
            o, ox, og = res["layers"][key]
            np.testing.assert_allclose(o, out, **TOL)
            want_x = np.split(gx, MP, axis=-1)[r] if parallel else gx
            np.testing.assert_allclose(ox, want_x, **TOL)
            np.testing.assert_allclose(og["bias"], g["bias"], **TOL)
        np.testing.assert_allclose(_cat(pair, key, "weight", 0),
                                   g["weight"], **TOL)


def test_vocab_parallel_embedding(ranks, jax_ref):
    out, _, g = jax_ref["emb"]
    for pair in _mp_pairs(ranks):
        for res in pair:
            np.testing.assert_allclose(res["layers"]["emb"][0], out, **TOL)
        np.testing.assert_allclose(_cat(pair, "emb", "weight", 0),
                                   g["weight"], **TOL)


def test_parallel_cross_entropy(ranks, jax_ref, arrays):
    loss, grad = jax_ref["pce"]
    ignored = arrays["labels"] == IGNORE
    assert ignored.any()
    for pair in _mp_pairs(ranks):
        for res in pair:
            np.testing.assert_allclose(res["layers"]["pce"][0], loss, **TOL)
            assert (res["layers"]["pce"][0][ignored] == 0).all()
        got = np.concatenate([p["layers"]["pce"][1] for p in pair], -1)
        np.testing.assert_allclose(got, grad, **TOL)
        assert (got[ignored] == 0).all()


def test_rng_tracker(ranks):
    """Outside ``rng_state`` every rank draws the same; inside it the two
    mp ranks differ and the dp replicas agree; the guard refuses a second
    state of one name or one seed, and an unknown name."""
    for res in ranks:
        assert res["rng"]["errors"][0] is not None
        assert "already exists" in res["rng"]["errors"][1]
        assert "does not exist" in res["rng"]["errors"][2]
        np.testing.assert_array_equal(res["rng"]["global"],
                                      ranks[0]["rng"]["global"])
        np.testing.assert_array_equal(res["rng"]["global_after"],
                                      ranks[0]["rng"]["global_after"])
    assert not np.array_equal(ranks[0]["rng"]["mp"], ranks[1]["rng"]["mp"])
    np.testing.assert_array_equal(ranks[0]["rng"]["mp"],
                                  ranks[2]["rng"]["mp"])
    np.testing.assert_array_equal(ranks[1]["rng"]["mp"],
                                  ranks[3]["rng"]["mp"])


def test_distributed_model_at_mp2(ranks):
    """A ``TensorParallel``: the mp layers keep their shards, a full-size
    parameter annotated ``("mp", None)`` is sliced to this rank's rows,
    the replicated parameters are broadcast from the group's first rank
    (equal on both mp ranks, different across the dp replicas that drew
    them apart), and ``apply_collective_grads`` sums the replicated
    gradients over the group."""
    full_head = np.arange(6 * H, dtype=np.float32).reshape(6, H)
    for pair in _mp_pairs(ranks):
        a, b = (p["dm"] for p in pair)
        assert a["type"] == b["type"] == "TensorParallel"
        assert a["col_shape"] == (IN, OUT // MP)
        np.testing.assert_array_equal(a["scale"], b["scale"])
        np.testing.assert_array_equal(a["row_bias"], b["row_bias"])
        np.testing.assert_array_equal(a["head"], full_head[:3])
        np.testing.assert_array_equal(b["head"], full_head[3:])
        np.testing.assert_allclose(a["grad_after"],
                                   a["grad_before"] + b["grad_before"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(a["grad_after"], b["grad_after"])
    assert not np.array_equal(ranks[0]["dm"]["scale"],
                              ranks[2]["dm"]["scale"])


def test_collectives_against_numpy(ranks):
    for r, res in enumerate(ranks):
        c = res["coll"]
        assert c["broadcast"] == [2.0, 2.0]
        assert c["reduce"] == [10.0]
        assert c["scatter"] == [10.0 * r, 10.0 * r + 1]
        assert c["reduce_scatter"] == [float(sum(q * 4 + r
                                                 for q in range(4)))]
        assert c["objects"] == [{"rank": q, "s": "x" * q} for q in range(4)]
        assert c["task"] == (True, True)
        assert c["axis_index"] == r


def test_fcollectives_values_and_transposes(ranks):
    """Each autograd form's forward against numpy, and its input gradient
    against the transpose rule (all_reduce <-> all_reduce, all_gather <->
    reduce_scatter, all_to_all <-> its inverse)."""
    xs = [np.arange(4, dtype=np.float32) + 10 * r for r in range(WORLD)]

    def w(r, n):
        return np.arange(n, dtype=np.float32) + r

    total = sum(xs)
    for r, res in enumerate(ranks):
        c = res["coll"]
        y, g = c["f_all_reduce"]
        np.testing.assert_array_equal(y, total)
        np.testing.assert_array_equal(g, sum(w(q, 4) for q in range(WORLD)))
        y, g = c["f_all_gather"]
        np.testing.assert_array_equal(y, np.concatenate(xs))
        np.testing.assert_array_equal(
            g, sum(w(q, 16) for q in range(WORLD))[4 * r:4 * r + 4])
        y, g = c["f_reduce_scatter"]
        np.testing.assert_array_equal(y, total[r:r + 1])
        np.testing.assert_array_equal(
            g, np.concatenate([w(q, 1) for q in range(WORLD)]))
        y, g = c["f_all_to_all"]
        np.testing.assert_array_equal(y, np.array([xs[q][r]
                                                   for q in range(WORLD)]))
        np.testing.assert_array_equal(
            g, np.array([w(q, 4)[r] for q in range(WORLD)]))


def test_generate_gpt_tp_example_tiny():
    """``examples/generate_gpt_tp_torch.py --tiny`` (config 3 at mp=2 on
    the CPU): every rank's greedy tokens equal rank 0's and an mp=1
    generate's; the fused stack at nranks=2 equals nranks=1 within
    1e-4."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "examples",
                                      "generate_gpt_tp_torch.py"), "--tiny"],
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("generate_gpt_tp:")][-1]
    rep = json.loads(line.split(":", 1)[1])
    assert rep["mp"] == 2 and rep["ranks_equal"] and rep["equals_mp1"]
    assert rep["fused_ok"] and rep["fused_max_abs_err"] <= 1e-4
