"""``nn.SyncBatchNorm`` of the port against the JAX package's
``BatchNorm2D`` on the concatenated batch (the reference's SPMD batch
norm over the global batch, ``paddle_tpu/nn/norm.py``).

In one world of two gloo processes each rank holds 4 of 8 images
(``[4, 3, 5, 5]``, f32) and runs two training forwards (running
statistics accumulate over both) and one backward of ``sum(out * ct)``:
each rank's output and input gradient equal the reference's rows of that
rank, the ranks' weight and bias gradients sum to the reference's (the
all-reduce's backward hands each rank the whole batch's statistics
gradient), and the running mean and variance equal the reference's on
both ranks; within 1e-5 (f32 sums in another order, the variance as
E[x^2] - E[x]^2). ``convert_sync_batchnorm`` swaps every batch norm of a
model for one that keeps its parameters and buffers. In a world of one
rank the layer is ``BatchNorm2D``.
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

N, C, HW = 8, 3, 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def arrays():
    r = np.random.default_rng(0)
    return dict(x=(1.5 + 2.0 * r.standard_normal((N, C, HW, HW))
                   ).astype(np.float32),
                x2=r.standard_normal((N, C, HW, HW)).astype(np.float32),
                ct=r.standard_normal((N, C, HW, HW)).astype(np.float32),
                w=(1.0 + 0.1 * r.standard_normal(C)).astype(np.float32),
                b=(0.1 * r.standard_normal(C)).astype(np.float32))


def _run(layer, a, rows):
    """Two training forwards (the second's input for the backward)."""
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(a["w"]))
        layer.bias.copy_(torch.from_numpy(a["b"]))
    layer.train()
    layer(torch.from_numpy(a["x2"][rows]))
    x = torch.from_numpy(a["x"][rows]).requires_grad_(True)
    out = layer(x)
    (out * torch.from_numpy(a["ct"][rows])).sum().backward()
    return dict(out=out.detach().numpy(), gx=x.grad.numpy(),
                gw=layer.weight.grad.numpy(), gb=layer.bias.grad.numpy(),
                mean=layer._mean.numpy().copy(),
                var=layer._variance.numpy().copy())


def _convert():
    from paddle_tpu_torch import nn

    net = nn.Sequential(nn.Conv2D(3, 4, 3, device="cpu"),
                        nn.BatchNorm2D(4, device="cpu"), nn.ReLU())
    bn = net[1]
    with torch.no_grad():
        bn._mean.fill_(0.25)
    conv = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    new = conv[1]
    return dict(type=type(new).__name__, same=conv is net,
                shares=(new.weight is bn.weight and new.bias is bn.bias
                        and new._mean is bn._mean),
                mean=new._mean.numpy().copy())


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch import nn

    a = dict(np.load(arrays_file))
    half = N // world
    rows = list(range(rank * half, (rank + 1) * half))
    res = dict(sync=_run(nn.SyncBatchNorm(C, device="cpu"), a, rows),
               convert=_convert())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sbn_world")
    np.savez(tmp / "arrays.npz", **arrays)
    return W.run_world(_worker, 2, tmp, str(tmp / "arrays.npz"))


@pytest.fixture(scope="module")
def reference(arrays):
    """The JAX ``BatchNorm2D`` on the whole batch: the same two forwards
    and backward."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import nn

    bn = nn.BatchNorm2D(C)
    bn.weight.set_value(jnp.asarray(arrays["w"]))
    bn.bias.set_value(jnp.asarray(arrays["b"]))
    bn.train()
    bn(paddle.to_tensor(arrays["x2"]))
    x = paddle.to_tensor(arrays["x"], stop_gradient=False)
    out = bn(x)
    (out * paddle.to_tensor(arrays["ct"])).sum().backward()
    return dict(out=np.asarray(out._data), gx=np.asarray(x.grad._data),
                gw=np.asarray(bn.weight.grad._data),
                gb=np.asarray(bn.bias.grad._data),
                mean=np.asarray(bn._mean._data),
                var=np.asarray(bn._variance._data))


def test_two_ranks_equal_the_global_batch_norm(ranks, reference):
    half = N // 2
    for rank, res in enumerate(ranks):
        got = res["sync"]
        rows = slice(rank * half, (rank + 1) * half)
        np.testing.assert_allclose(got["out"], reference["out"][rows], **TOL)
        np.testing.assert_allclose(got["gx"], reference["gx"][rows], **TOL)
        np.testing.assert_allclose(got["mean"], reference["mean"], **TOL)
        np.testing.assert_allclose(got["var"], reference["var"], **TOL)
    for key in ("gw", "gb"):
        np.testing.assert_allclose(
            ranks[0]["sync"][key] + ranks[1]["sync"][key], reference[key],
            **TOL)


def test_convert_sync_batchnorm_keeps_the_state(ranks):
    for res in ranks:
        cv = res["convert"]
        assert cv["type"] == "SyncBatchNorm" and cv["same"] and cv["shares"]
        np.testing.assert_array_equal(cv["mean"], np.full(4, 0.25,
                                                          np.float32))


@pytest.mark.parametrize("world", ["none", "one"])
def test_one_rank_is_batch_norm(arrays, reference, world):
    """With no world, or a world of one, the layer is the batch norm of
    its own batch: the whole batch here, against the reference."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import (destroy_process_group,
                                              init_parallel_env)

    if world == "one":
        init_parallel_env(device="cpu")
    try:
        got = _run(nn.SyncBatchNorm(C, device="cpu"), arrays,
                   list(range(N)))
    finally:
        if world == "one":
            destroy_process_group()
    for key, want in reference.items():
        np.testing.assert_allclose(got[key], want, **TOL)
