"""Sequence parallelism of the port
(``fleet/utils/sequence_parallel_utils.py``) at mp = 2, in ONE world of
two gloo processes (``tests/_torch_world.py``), against the JAX package's
layers on the whole sequence.

- The four ops on a ``[seq, batch, hidden]`` tensor: ``ScatterOp`` keeps
  the rank's slice of the sequence and its backward all-gathers;
  ``GatherOp`` all-gathers and its backward slices; ``AllGatherOp``'s
  backward reduce-scatters; ``ReduceScatterOp`` sums and slices, its
  backward all-gathers. Values and input gradients against numpy, exact
  (sums of two f32 values, in rank order).
- A sequence-parallel MLP block (the reference's pattern: ``LayerNorm`` on
  the sequence slice, ``ColumnSequenceParallelLinear`` -> GELU ->
  ``RowSequenceParallelLinear``, the residual, ``GatherOp``) against the
  reference's ``LayerNorm`` / ``ColumnSequenceParallelLinear`` /
  ``RowSequenceParallelLinear`` on the whole sequence with the same numpy
  weights: the output, the input's gradient, each rank's shard of the
  column and row weights' gradients, and the marked parameters' gradients
  (the LayerNorm's and the row bias) after
  ``create_fused_allreduce_gradient_hook``'s sum over mp, all within 1e-5
  (f32 sums in another order). Before the hook each rank holds a part of
  those gradients, and the two parts sum to the whole.
- ``HybridParallelOptimizer`` (``fleet.distributed_optimizer``) sums the
  marked parameters' gradients over mp itself: one SGD step of the block
  through it gives the reference's step within 1e-6.
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

MP = 2
S, B, H = 8, 2, 16
TOL = 1e-5
LR = 0.1


def _weights():
    r = np.random.default_rng(11)
    return dict(
        ln_w=(1.0 + 0.1 * r.standard_normal(H)).astype(np.float32),
        ln_b=(0.1 * r.standard_normal(H)).astype(np.float32),
        w1=(0.3 * r.standard_normal((H, 4 * H))).astype(np.float32),
        b1=(0.1 * r.standard_normal(4 * H)).astype(np.float32),
        w2=(0.3 * r.standard_normal((4 * H, H))).astype(np.float32),
        b2=(0.1 * r.standard_normal(H)).astype(np.float32),
        x=r.standard_normal((S, B, H)).astype(np.float32),
        gout=r.standard_normal((S, B, H)).astype(np.float32))


def _port_block(w, rank):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu

    ln = nn.LayerNorm(H, device="cpu")
    col = spu.ColumnSequenceParallelLinear(H, 4 * H, device="cpu")
    row = spu.RowSequenceParallelLinear(4 * H, H, device="cpu")
    c = slice(rank * 2 * H, (rank + 1) * 2 * H)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w["ln_w"]))
        ln.bias.copy_(torch.from_numpy(w["ln_b"]))
        col.weight.copy_(torch.from_numpy(w["w1"][:, c]))
        col.bias.copy_(torch.from_numpy(w["b1"][c]))
        row.weight.copy_(torch.from_numpy(w["w2"][c, :]))
        row.bias.copy_(torch.from_numpy(w["b2"]))
    for p in ln.parameters():
        spu.mark_as_sequence_parallel_parameter(p)
    return ln, col, row


def _port_forward(spu, ln, col, row, x_full):
    from paddle_tpu_torch.nn import functional as F

    xs = spu.ScatterOp.apply(x_full)
    h = row(F.gelu(col(ln(xs))))
    return spu.GatherOp.apply(xs + h)


def _worker(rank, world, init_file, out_dir, w_file):
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as spu

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"mp_degree": MP}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    w = dict(np.load(w_file))
    res = {}
    # the four ops
    base = torch.arange(S * 3, dtype=torch.float32).reshape(S, 3) \
        + 100 * rank
    ops = {}
    for name in ("ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp"):
        x = base.clone().requires_grad_(True)
        y = getattr(spu, name).apply(x)
        g = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
            + 1000 * rank
        y.backward(g)
        ops[name] = (y.detach().numpy(), x.grad.numpy())
    res["ops"] = ops
    # the block
    ln, col, row = _port_block(w, rank)
    x = torch.from_numpy(w["x"]).requires_grad_(True)
    out = _port_forward(spu, ln, col, row, x)
    out.backward(torch.from_numpy(w["gout"]))
    params = [*ln.parameters(), *col.parameters(), *row.parameters()]
    res["before"] = {k: v.grad.numpy().copy() for k, v in
                     (("ln_w", ln.weight), ("ln_b", ln.bias),
                      ("b2", row.bias))}
    spu.create_fused_allreduce_gradient_hook(params)()
    res.update(out=out.detach().numpy(), gx=x.grad.numpy(),
               g=dict(ln_w=ln.weight.grad.numpy(), ln_b=ln.bias.grad.numpy(),
                      w1=col.weight.grad.numpy(), b1=col.bias.grad.numpy(),
                      w2=row.weight.grad.numpy(), b2=row.bias.grad.numpy()),
               marked=[spu.is_sequence_parallel_parameter(p)
                       for p in (ln.weight, row.bias, col.weight)])
    # one SGD step through the fleet optimizer (it sums the marked ones)
    ln, col, row = _port_block(w, rank)
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=LR, parameters=[*ln.parameters(), *col.parameters(),
                                      *row.parameters()]))
    _port_forward(spu, ln, col, row, torch.from_numpy(w["x"])).backward(
        torch.from_numpy(w["gout"]))
    opt.step()
    res["sgd"] = dict(ln_w=ln.weight.detach().numpy(),
                      ln_b=ln.bias.detach().numpy(),
                      w1=col.weight.detach().numpy(),
                      b2=row.bias.detach().numpy())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_world")
    np.savez(tmp / "w.npz", **weights)
    return W.run_world(_worker, MP, tmp, str(tmp / "w.npz"))


@pytest.fixture(scope="module")
def ref(weights):
    """The reference's layers on the whole sequence: output, the input's
    gradient, every parameter's gradient (eager tape)."""
    import jax.numpy as jnp

    import paddle_tpu.nn.functional as JF
    from paddle_tpu import nn
    from paddle_tpu.distributed.fleet.utils import \
        sequence_parallel_utils as jspu
    from paddle_tpu.framework.tensor import Tensor

    w = weights
    ln = nn.LayerNorm(H)
    col = jspu.ColumnSequenceParallelLinear(H, 4 * H)
    row = jspu.RowSequenceParallelLinear(4 * H, H)
    for p, k in ((ln.weight, "ln_w"), (ln.bias, "ln_b"), (col.weight, "w1"),
                 (col.bias, "b1"), (row.weight, "w2"), (row.bias, "b2")):
        p._data = jnp.asarray(w[k])
    x = Tensor(jnp.asarray(w["x"]), stop_gradient=False)
    xs = jspu.ScatterOp.apply(x)
    out = jspu.GatherOp.apply(xs + row(JF.gelu(col(ln(xs)))))
    (out * Tensor(jnp.asarray(w["gout"]))).sum().backward()
    g = {k: np.asarray(p.grad._data if hasattr(p.grad, "_data")
                       else p.grad)
         for p, k in ((ln.weight, "ln_w"), (ln.bias, "ln_b"),
                      (col.weight, "w1"), (col.bias, "b1"),
                      (row.weight, "w2"), (row.bias, "b2"))}
    gx = x.grad._data if hasattr(x.grad, "_data") else x.grad
    return dict(out=np.asarray(out._data), gx=np.asarray(gx), g=g)


def _shard(name, a, rank):
    c = slice(rank * 2 * H, (rank + 1) * 2 * H)
    if name in ("w1",):
        return a[:, c]
    if name in ("b1",):
        return a[c]
    if name == "w2":
        return a[c, :]
    return a


def test_ops_values_and_transposes(ranks):
    xs = [np.arange(S * 3, dtype=np.float32).reshape(S, 3) + 100 * r
          for r in range(MP)]
    half = S // MP
    for r, res in enumerate(ranks):
        o = res["ops"]
        # scatter: my slice; backward all-gathers the slices' gradients
        np.testing.assert_array_equal(o["ScatterOp"][0],
                                      xs[r][r * half:(r + 1) * half])
        gs = [np.arange(half * 3, dtype=np.float32).reshape(half, 3)
              + 1000 * q for q in range(MP)]
        np.testing.assert_array_equal(o["ScatterOp"][1],
                                      np.concatenate(gs))
        # gather: everyone's whole; backward keeps my slice
        np.testing.assert_array_equal(o["GatherOp"][0], np.concatenate(xs))
        g = np.arange(S * MP * 3, dtype=np.float32).reshape(S * MP, 3) \
            + 1000 * r
        np.testing.assert_array_equal(o["GatherOp"][1],
                                      g[r * S:(r + 1) * S])
        # all-gather: backward sums the ranks' gradients and slices
        np.testing.assert_array_equal(o["AllGatherOp"][0],
                                      np.concatenate(xs))
        gsum = sum(np.arange(S * MP * 3, dtype=np.float32)
                   .reshape(S * MP, 3) + 1000 * q for q in range(MP))
        np.testing.assert_array_equal(o["AllGatherOp"][1],
                                      gsum[r * S:(r + 1) * S])
        # reduce-scatter: the sum's slice; backward all-gathers
        np.testing.assert_array_equal(o["ReduceScatterOp"][0],
                                      sum(xs)[r * half:(r + 1) * half])
        np.testing.assert_array_equal(o["ReduceScatterOp"][1],
                                      np.concatenate(gs))


def test_block_matches_reference(ranks, ref):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["out"], ref["out"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res["gx"], ref["gx"], rtol=TOL, atol=TOL)
        for k, want in ref["g"].items():
            np.testing.assert_allclose(res["g"][k], _shard(k, want, r),
                                       rtol=TOL, atol=TOL, err_msg=k)
        assert res["marked"] == [True, True, False]


def test_marked_gradients_are_parts_before_the_hook(ranks, ref):
    for k in ("ln_w", "ln_b", "b2"):
        parts = [res["before"][k] for res in ranks]
        assert not np.allclose(parts[0], ref["g"][k], atol=TOL), k
        np.testing.assert_allclose(parts[0] + parts[1], ref["g"][k],
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_fleet_optimizer_sums_marked_gradients(ranks, ref, weights):
    for r, res in enumerate(ranks):
        for k, got in res["sgd"].items():
            want = _shard(k, weights[k] - LR * ref["g"][k], r)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=k)
