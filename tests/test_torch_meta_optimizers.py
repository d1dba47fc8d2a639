"""The port's hybrid-parallel optimizer glue
(``distributed/fleet/meta_optimizers``, ``fleet/utils``) against the JAX
package.

In one process: the reference's own ``TestDGC`` cases
(``tests/test_meta_optimizers.py``) run on both packages, value for value;
``LocalSGDOptimizer``'s sync cadence; ``GradientMergeOptimizer`` (k = 4,
avg) against the JAX one and against one step on the whole batch;
``HybridParallelOptimizer`` without a topology swapping in the hybrid
clip and stepping as the JAX one; main-grad mixed precision
(``MixPrecisionLayer`` / ``MixPrecisionOptimizer``) against the JAX
pair.

In one world of two gloo processes: the hybrid clip's norm, with the
gradients split over ``sharding`` (sharded-optimizer slices) and then
over ``mp`` (``is_distributed`` shards), equals the norm of the whole
gradient on every rank, and both ranks scale alike; ``found_inf`` on one
rank skips the step on both (the scale halves on both, as the JAX
scaler's); ``LocalSGDOptimizer`` averages the parameters every
``k_steps``; DGC with ``sync`` applies the mean of the ranks' masked
gradients (each rank's mask is the JAX DGC's).
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

TOL = dict(rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ one process
class _DGCPair:
    """One parameter of ``vals`` and a DGC wrapper over SGD(lr 1) in each
    package."""

    def __init__(self, vals, **kw):
        import paddle_tpu as paddle
        from paddle_tpu import optimizer as jopt
        from paddle_tpu.distributed.fleet.meta_optimizers import \
            DGCMomentumOptimizer as JDGC

        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
            DGCMomentumOptimizer

        self._paddle = paddle
        self.jw = paddle.framework.Parameter(np.asarray(vals, np.float32))
        self.jdgc = JDGC(jopt.SGD(learning_rate=1.0, parameters=[self.jw]),
                         **kw)
        self.tw = torch.nn.Parameter(torch.tensor(vals, dtype=torch.float32))
        self.tdgc = DGCMomentumOptimizer(
            optimizer.SGD(learning_rate=1.0, parameters=[self.tw]), **kw)

    def step(self, g):
        g = np.asarray(g, np.float32)
        self.jw.grad = self._paddle.to_tensor(g)
        self.jdgc.step()
        self.tw.grad = torch.from_numpy(g.copy())
        self.tdgc.step()
        got = self.tw.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(self.jw), **TOL)
        return got


def test_dgc_topk_selection_and_residual():
    d = _DGCPair(np.zeros(4), momentum=0.0, rampup_begin_step=0,
                 sparsity=(0.75,), sync=False)
    g = [0.1, -4.0, 0.2, 0.3]
    np.testing.assert_allclose(d.step(g), [0.0, 4.0, 0.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(d.step(g), [0.0, 8.0, 0.0, 0.0], rtol=1e-5)
    np.testing.assert_allclose(d.step(np.zeros(4)), [0.0, 8.0, 0.0, -0.6],
                               rtol=1e-5)


def test_dgc_nothing_lost_over_time():
    d = _DGCPair(np.zeros(8), momentum=0.0, sparsity=(0.875,), sync=False)
    g = np.linspace(0.1, 0.8, 8).astype(np.float32)
    for _ in range(40):
        w = d.step(g)
    np.testing.assert_allclose(-w, 40 * g, rtol=0.35)


def test_dgc_rampup_schedule():
    d = _DGCPair(np.zeros(4), rampup_begin_step=2, rampup_step=2,
                 sparsity=(0.5, 0.75), sync=False)
    seen = []
    for _ in range(7):
        seen.append(d.tdgc.current_sparsity())
        assert seen[-1] == d.jdgc.current_sparsity()
        d.step(np.ones(4))
    assert seen == [0.0, 0.0, 0.5, 0.5, 0.75, 0.75, 0.75]


def test_dgc_momentum_factor_masking():
    d = _DGCPair(np.zeros(2), momentum=0.5, sparsity=(0.5,), sync=False)
    g = [1.0, 0.4]
    np.testing.assert_allclose(d.step(g), [-1.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(d.step(g), [-2.0, -1.0], rtol=1e-5)


def test_local_sgd_sync_cadence(monkeypatch):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDOptimizer

    net = nn.Linear(4, 4, device="cpu")
    opt = LocalSGDOptimizer(optimizer.SGD(learning_rate=0.1,
                                          parameters=net.parameters()),
                            k_steps=3)
    calls = []
    monkeypatch.setattr(opt, "_sync_params", lambda: calls.append(1))
    x = torch.ones(2, 4)
    for _ in range(7):
        net(x).pow(2).mean().backward()
        opt.step()
        opt.clear_grad()
    assert len(calls) == 2


def _linear_pair(d_in, d_out, seed=0):
    """A JAX Linear and a port Linear holding the same numpy weights."""
    import jax.numpy as jnp

    from paddle_tpu import nn as jnn

    from paddle_tpu_torch import nn

    r = np.random.default_rng(seed)
    w = r.standard_normal((d_in, d_out)).astype(np.float32)
    b = r.standard_normal(d_out).astype(np.float32)
    jl = jnn.Linear(d_in, d_out)
    jl.weight.set_value(jnp.asarray(w))
    jl.bias.set_value(jnp.asarray(b))
    tl = nn.Linear(d_in, d_out, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


def test_gradient_merge_matches_the_reference():
    """k = 4 micro-steps with avg against the JAX wrapper, and against one
    SGD step on the whole batch (the reference test's equivalence)."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer as JGM

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer

    jl, tl = _linear_pair(6, 1)
    _, big = _linear_pair(6, 1)
    jo = JGM(jopt.SGD(learning_rate=0.1, parameters=jl.parameters()),
             k_steps=4, avg=True)
    to = GradientMergeOptimizer(optimizer.SGD(
        learning_rate=0.1, parameters=tl.parameters()), k_steps=4, avg=True)
    r = np.random.default_rng(1)
    xs = r.standard_normal((16, 6)).astype(np.float32)
    ys = r.standard_normal((16, 1)).astype(np.float32)
    for i in range(4):
        xb, yb = xs[4 * i:4 * i + 4], ys[4 * i:4 * i + 4]
        ((jl(paddle.to_tensor(xb)) - paddle.to_tensor(yb)) ** 2).sum() \
            .backward()
        jo.step()
        ((tl(torch.from_numpy(xb)) - torch.from_numpy(yb)) ** 2).sum() \
            .backward()
        to.step()
        to.clear_grad()  # a no-op inside the window
        assert to.steps_accumulated == (i + 1) % 4
    bo = optimizer.SGD(learning_rate=0.1, parameters=big.parameters())
    ((big(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2).sum() \
        .div(4).backward()
    bo.step()
    for name, p in tl.named_parameters():
        want = np.asarray(getattr(jl, name)._data)
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(p.detach().numpy(),
                                   getattr(big, name).detach().numpy(),
                                   atol=1e-5)


def test_hybrid_optimizer_alone_matches_the_reference():
    """Without a topology: the clip becomes the hybrid clip (on both
    packages) and a clipped AdamW step equals the JAX one."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        HybridParallelOptimizer as JHPO
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelOptimizer
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    jl, tl = _linear_pair(8, 3, seed=2)
    jinner = jopt.AdamW(learning_rate=0.01, parameters=jl.parameters(),
                        grad_clip=JClip(0.5))
    tinner = optimizer.AdamW(learning_rate=0.01,
                             parameters=tl.named_parameters(),
                             grad_clip=ClipGradByGlobalNorm(0.5))
    jo, to = JHPO(jinner, hcg=None), HybridParallelOptimizer(tinner)
    assert type(jinner._grad_clip).__name__ == \
        type(tinner._grad_clip).__name__ == "HybridParallelClipGrad"
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    for _ in range(2):
        jl(paddle.to_tensor(x)).pow(2).sum().backward()
        jo.step()
        jo.clear_grad()
        tl(torch.from_numpy(x)).pow(2).sum().backward()
        to.step()
        to.clear_grad()
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(getattr(jl, name)._data),
                                   atol=1e-6, err_msg=name)


def test_mix_precision_matches_the_reference():
    """bf16 parameters, f32 main gradients accumulated over two
    backwards, an AdamW step on them against the f32 masters; against the
    JAX pair (bf16 parameters equal, f32 main gradients within 1e-6)."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.utils.mix_precision_utils import (
        MixPrecisionLayer as JMPL, MixPrecisionOptimizer as JMPO)

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.utils.mix_precision_utils \
        import MixPrecisionLayer, MixPrecisionOptimizer

    jl, tl = _linear_pair(4, 2, seed=4)
    jw, tw = JMPL(jl, dtype="bfloat16"), MixPrecisionLayer(tl)
    assert tl.weight.dtype == torch.bfloat16
    jo = JMPO(jopt.AdamW(learning_rate=0.05, parameters=jl.parameters(),
                         multi_precision=True))
    to = MixPrecisionOptimizer(optimizer.AdamW(
        learning_rate=0.05, parameters=tl.parameters(),
        multi_precision=True))
    x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    for _ in range(2):
        jw(paddle.to_tensor(jnp.asarray(x, jnp.bfloat16))).astype(
            "float32").sum().backward()
        tw(torch.from_numpy(x).bfloat16()).float().sum().backward()
    for name in ("weight", "bias"):
        tp, jp = getattr(tl, name), getattr(jl, name)
        assert tp.main_grad.dtype == torch.float32
        np.testing.assert_allclose(tp.main_grad.numpy(),
                                   np.asarray(jp.main_grad._data),
                                   rtol=1e-6, atol=1e-6)
    jo.step()
    jo.clear_grad()
    to.step()
    to.clear_grad()
    for name in ("weight", "bias"):
        tp, jp = getattr(tl, name), getattr(jl, name)
        assert tp.main_grad is None
        np.testing.assert_array_equal(
            tp.detach().float().numpy(),
            np.asarray(jp._data.astype(jnp.float32)))


# ------------------------------------------------------------- the world
def _clip_norms(rank, whole):
    """The hybrid clip over the world laid out at sharding = 2 (each rank
    holds dim-0 halves of the cut tensors, the rest whole) and then at
    mp = 2 (halves marked ``is_distributed``)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelClipGrad
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    out = {}
    for axis, flag in (("sharding", "is_sharding_slice"),
                       ("mp", "is_distributed")):
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {f"{axis}_degree": 2}
        fleet.init(is_collective=True, strategy=st, device="cpu")
        clip = HybridParallelClipGrad(ClipGradByGlobalNorm(1.0),
                                      fleet.get_hybrid_communicate_group())
        pairs = []
        for i, g in enumerate(whole):
            g = torch.from_numpy(g.copy())
            p = torch.nn.Parameter(torch.zeros(1))
            if i % 2 == 0:  # cut in two along dim 0
                g = g.chunk(2)[rank].clone()
                setattr(p, flag, True)
            pairs.append((p, g))
        out[axis] = (float(clip.global_norm(pairs)),
                     [g.numpy().copy() for _, g in clip(pairs)])
    return out


def _found_inf(rank):
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelGradScaler

    w = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = HybridParallelGradScaler(amp.GradScaler(init_loss_scaling=1024))
    w.grad = torch.tensor([1.0, float("inf") if rank == 1 else 2.0, 3.0])
    scaler.step(opt)
    return dict(w=w.detach().numpy().copy(), scale=scaler._scale)


def _local_sgd(rank):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDOptimizer

    w = torch.nn.Parameter(torch.tensor([1.0, -1.0]))
    opt = LocalSGDOptimizer(optimizer.SGD(learning_rate=0.5,
                                          parameters=[w]), k_steps=2)
    grads = [torch.tensor([1.0 + rank, 2.0]),
             torch.tensor([0.5, -1.0 - rank])]
    seen = []
    for g in grads:
        w.grad = g
        opt.step()
        opt.clear_grad()
        seen.append(w.detach().numpy().copy())
    return seen


def _dgc_sync(rank, g):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DGCMomentumOptimizer

    w = torch.nn.Parameter(torch.zeros(4))
    dgc = DGCMomentumOptimizer(optimizer.SGD(learning_rate=1.0,
                                             parameters=[w]),
                               momentum=0.0, sparsity=(0.5,), sync=True)
    w.grad = torch.from_numpy(g.copy())
    dgc.step()
    return w.detach().numpy().copy()


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    a = dict(np.load(arrays_file))
    whole = [a[f"g{i}"] for i in range(4)]
    res = dict(clip=_clip_norms(rank, whole), found_inf=_found_inf(rank),
               local_sgd=_local_sgd(rank),
               dgc=_dgc_sync(rank, a[f"dgc{rank}"]))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def arrays():
    r = np.random.default_rng(7)
    out = {f"g{i}": r.standard_normal(s).astype(np.float32)
           for i, s in enumerate([(4, 3), (5,), (6,), (2, 2)])}
    out["dgc0"] = np.array([0.1, -4.0, 0.2, 0.3], np.float32)
    out["dgc1"] = np.array([2.0, 0.5, -0.1, 0.3], np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meta_world")
    np.savez(tmp / "arrays.npz", **arrays)
    return W.run_world(_worker, 2, tmp, str(tmp / "arrays.npz"))


@pytest.mark.parametrize("axis", ["sharding", "mp"])
def test_hybrid_clip_norm_is_the_whole_norm(ranks, arrays, axis):
    whole = [arrays[f"g{i}"] for i in range(4)]
    want = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in whole)))
    scale = 1.0 / want
    for rank, res in enumerate(ranks):
        norm, clipped = res["clip"][axis]
        np.testing.assert_allclose(norm, want, rtol=1e-6)
        for i, (g, c) in enumerate(zip(whole, clipped)):
            if i % 2 == 0:
                g = np.split(g, 2)[rank]
            np.testing.assert_allclose(c, g * scale, rtol=1e-5, atol=1e-7)


def test_found_inf_on_one_rank_skips_every_rank(ranks):
    from paddle_tpu import amp as jamp

    js = jamp.GradScaler(init_loss_scaling=1024)
    js._found_inf = True
    js.update()
    for res in ranks:
        np.testing.assert_array_equal(res["found_inf"]["w"], np.ones(3))
        assert res["found_inf"]["scale"] == js._scale == 512


def test_local_sgd_averages_parameters_every_k(ranks):
    w0 = np.array([1.0, -1.0], np.float32)
    runs = []
    for rank in range(2):
        g1 = np.array([1.0 + rank, 2.0], np.float32)
        g2 = np.array([0.5, -1.0 - rank], np.float32)
        runs.append((w0 - 0.5 * g1, w0 - 0.5 * g1 - 0.5 * g2))
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res["local_sgd"][0], runs[rank][0],
                                   **TOL)
        np.testing.assert_allclose(res["local_sgd"][1],
                                   np.mean([r[1] for r in runs], axis=0),
                                   **TOL)
    assert not np.array_equal(ranks[0]["local_sgd"][0],
                              ranks[1]["local_sgd"][0])


def test_dgc_sync_applies_the_mean_of_the_masked_gradients(ranks, arrays):
    """Each rank's send is the JAX DGC's (sync off) on its gradient; the
    synced step applies their mean on both ranks."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        DGCMomentumOptimizer as JDGC

    sends = []
    for rank in range(2):
        w = paddle.framework.Parameter(np.zeros(4, np.float32))
        d = JDGC(jopt.SGD(learning_rate=1.0, parameters=[w]),
                 momentum=0.0, sparsity=(0.5,), sync=False)
        w.grad = paddle.to_tensor(arrays[f"dgc{rank}"])
        d.step()
        sends.append(-np.asarray(w))
    for res in ranks:
        np.testing.assert_allclose(res["dgc"], -np.mean(sends, axis=0),
                                   **TOL)
