"""Data parallelism of the port (``distributed/parallel.py``
``DataParallel``, ``fleet.distributed_model`` / ``distributed_optimizer``
at dp > 1, ``fleet.utils.fused_allreduce_gradients``) and config 2 at
dp = 2 (``examples/train_bert_dp_torch.py``), in one world of two gloo
processes.

- The example's ``dp_step`` for three steps on a tiny BERT (2 layers,
  width 32, vocab 128, f32), global batch 16 x 32 split over the ranks by
  ``DistributedBatchSampler``, against the reference example's jitted
  step (``examples/train_bert_dp.py``: ``functional_call``,
  ``jax.value_and_grad``, ``apply_gradients_tree``) on the whole batch,
  sharded over a two-device ``dp`` mesh of the 8-device CPU mesh. The
  reference's labels give every row the same count of labelled tokens,
  so the mean of the ranks' losses is the global loss. Losses within
  1e-5 relative and parameters within 1e-5 (a key bias: 2e-4 a step, as
  ``test_torch_bert.py`` holds it): f32 sums in another order. After
  every step the two ranks' parameters are bitwise equal.
- The same through ``fleet``: ``distributed_model`` (the model itself,
  rank 0's parameters broadcast to rank 1, as the reference returns it at
  pure dp) and ``distributed_optimizer(AdamW(grad_clip=ClipGradByGlobalNorm(1.0)))``
  (a ``HybridParallelOptimizer``), eager ``loss.backward(); opt.step()``,
  against the JAX package's eager AdamW with the same clip on the whole
  batch.
- ``no_sync`` accumulates unsynchronised, then the next
  ``apply_collective_grads`` averages the accumulated gradients.
- The bucketed all-reduce (many small buckets, one large) equals one
  all-reduce a tensor bitwise (each element is the same two values
  summed).
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD = 2
STEPS = 3
TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BATCH, SEQ = 16, 32


def _example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_bert_dp_torch.py"
    spec = importlib.util.spec_from_file_location("train_bert_dp_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights():
    """Random f32 arrays for every parameter of the tiny BERT (the
    reference's names), from a numpy seed."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    r = np.random.default_rng(0)
    out = {}
    for name, p in BertForMaskedLM(BertConfig(**TINY),
                                   device="cpu").named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = 0.2 * r.standard_normal(shape)
        else:
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            v = base + 0.1 * r.standard_normal(shape)
        out[name] = v.astype(np.float32)
    return out


def _batches():
    ex = _example()
    rng = np.random.default_rng(0)
    return [ex.global_batch(rng, TINY["vocab_size"], BATCH, SEQ)
            for _ in range(STEPS)]


def _np(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


# ------------------------------------------------------------ the ranks
def _example_steps(rank, arrays, batches):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import bert_from_numpy
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce, fleet
    from paddle_tpu_torch.jit import param_arrays
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertPretrainingCriterion)

    ex = _example()
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(),
               device="cpu")
    group = fleet.get_hybrid_communicate_group().get_data_parallel_group()
    model = bert_from_numpy(BertConfig(**TINY), arrays, device="cpu")
    model.train()
    crit = BertPretrainingCriterion(TINY["vocab_size"])
    opt = optimizer.AdamW(learning_rate=1e-4)
    params = param_arrays(model)
    state = opt.init_state_tree(params)
    rows = ex.rank_rows(BATCH, rank, WORLD)
    out = dict(rows=list(rows), local=[], loss=[], params=[], calls=[])
    for i, (ids, labels) in enumerate(batches):
        params, state, loss, calls = ex.dp_step(
            model, crit, opt, params, state, torch.from_numpy(ids[rows]),
            torch.from_numpy(labels[rows]), i + 1, group)
        out["local"].append(float(loss))
        out["loss"].append(float(all_reduce(loss.reshape(1).clone(),
                                            op=ReduceOp.AVG, group=group)))
        out["params"].append(_np(params))
        out["calls"].append(calls)
    return out


def _fleet_steps(rank, arrays, batches):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import bert_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertPretrainingCriterion)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    ex = _example()
    torch.manual_seed(100 + rank)  # the replicas must not rely on it
    model = bert_from_numpy(BertConfig(**TINY), arrays, device="cpu")
    if rank == 1:  # rank 0's weights reach rank 1 by the wrap's broadcast
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    model.train()
    dp_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    crit = BertPretrainingCriterion(TINY["vocab_size"])
    rows = ex.rank_rows(BATCH, rank, WORLD)
    out = dict(types=(dp_model is model, type(opt).__name__,
                      type(opt._inner_opt._grad_clip).__name__),
               local=[], params=[], buckets=[])
    for ids, labels in batches:
        loss = crit(dp_model(torch.from_numpy(ids[rows])),
                    torch.from_numpy(labels[rows]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out["local"].append(float(loss))
        out["buckets"].append(opt.last_buckets)
        out["params"].append({k: v.detach().numpy().copy()
                              for k, v in model.named_parameters()})
    return out


def _no_sync(rank):
    from paddle_tpu_torch.distributed import DataParallel

    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.arange(12.0).reshape(3, 4) / 10)
        lin.bias.zero_()
    dp = DataParallel(lin)
    r = np.random.default_rng(10 + rank)
    xs = [torch.from_numpy(r.standard_normal((2, 4)).astype(np.float32))
          for _ in range(2)]
    with dp.no_sync():
        dp(xs[0]).pow(2).sum().backward()
        dp.apply_collective_grads()
    inside = lin.weight.grad.numpy().copy()
    dp(xs[1]).pow(2).sum().backward()
    dp.apply_collective_grads()
    return dict(xs=[x.numpy() for x in xs], inside=inside,
                after=lin.weight.grad.numpy().copy(),
                bias_after=lin.bias.grad.numpy().copy(),
                buckets=dp.last_buckets)


def _buckets(rank):
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce
    from paddle_tpu_torch.distributed.parallel import allreduce_buckets

    r = np.random.default_rng(20 + rank)
    shapes = [(3, 5), (7,), (100,), (2, 2, 2), (64, 33), (1,)]
    base = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            for s in shapes]
    per = [b.clone() for b in base]
    for t in per:
        all_reduce(t, op=ReduceOp.AVG)
    small = [b.clone() for b in base]
    n_small = allreduce_buckets(small, None, "avg", bucket_mb=2e-4)
    large = [b.clone() for b in base]
    n_large = allreduce_buckets(large, None, "avg", bucket_mb=25)
    return dict(per=[t.numpy() for t in per],
                small=[t.numpy() for t in small],
                large=[t.numpy() for t in large],
                calls=(n_small, n_large))


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    data = dict(np.load(arrays_file))
    arrays = {k[2:]: v for k, v in data.items() if k.startswith("w:")}
    batches = [(data[f"ids{i}"], data[f"labels{i}"]) for i in range(STEPS)]
    res = dict(example=_example_steps(rank, arrays, batches))
    res["fleet"] = _fleet_steps(rank, arrays, batches)
    res["no_sync"] = _no_sync(rank)
    res["buckets"] = _buckets(rank)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def arrays():
    return _weights()


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.fixture(scope="module")
def ranks(arrays, batches, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_world")
    data = {f"w:{k}": v for k, v in arrays.items()}
    for i, (ids, labels) in enumerate(batches):
        data[f"ids{i}"], data[f"labels{i}"] = ids, labels
    np.savez(tmp / "arrays.npz", **data)
    return W.run_world(_worker, WORLD, tmp, str(tmp / "arrays.npz"))


# ------------------------------------------------------- the JAX side
def _jax_model(arrays):
    import jax.numpy as jnp

    from paddle_tpu.models.bert import BertConfig, BertForMaskedLM

    jm = BertForMaskedLM(BertConfig(**TINY))
    for name, p in jm.named_parameters():
        p.set_value(jnp.asarray(arrays[name]))
    jm.train()
    return jm


@pytest.fixture(scope="module")
def jax_example(arrays, batches):
    """``examples/train_bert_dp.py``'s step on the whole batch, the batch
    sharded over a two-device ``dp`` mesh."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from paddle_tpu import optimizer
    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.jit import functional_call, param_arrays
    from paddle_tpu.models.bert import BertPretrainingCriterion

    model = _jax_model(arrays)
    crit = BertPretrainingCriterion(TINY["vocab_size"])
    opt = optimizer.AdamW(learning_rate=1e-4)
    params = param_arrays(model)
    opt_state = opt.init_state_tree(params)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    data_sharding = NamedSharding(mesh, P("dp"))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, ids, labels, step_i):
        def loss_fn(p):
            logits = functional_call(model, p, Tensor._wrap(ids))
            return crit(Tensor._wrap(logits), Tensor._wrap(labels))._data

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_p, new_s = opt.apply_gradients_tree(params, grads, opt_state,
                                                1e-4, step_i)
        return new_p, new_s, loss

    out = dict(loss=[], params=[])
    for i, (ids, labels) in enumerate(batches):
        params, opt_state, loss = step(
            params, opt_state,
            jax.device_put(jnp.asarray(ids), data_sharding),
            jax.device_put(jnp.asarray(labels), data_sharding),
            jnp.float32(i + 1))
        out["loss"].append(float(loss))
        out["params"].append({k: np.asarray(v) for k, v in params.items()})
    return out


@pytest.fixture(scope="module")
def jax_eager(arrays, batches):
    """The JAX package's eager AdamW with ``ClipGradByGlobalNorm(1.0)`` on
    the whole batch."""
    import jax.numpy as jnp

    from paddle_tpu import optimizer
    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.models.bert import BertPretrainingCriterion
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm

    jm = _jax_model(arrays)
    crit = BertPretrainingCriterion(TINY["vocab_size"])
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                          grad_clip=ClipGradByGlobalNorm(1.0))
    out = dict(loss=[], params=[])
    for ids, labels in batches:
        loss = crit(jm(Tensor(jnp.asarray(ids))),
                    Tensor(jnp.asarray(labels)))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out["loss"].append(float(np.asarray(loss._data)))
        out["params"].append({n: np.asarray(p._data)
                              for n, p in jm.named_parameters()})
    return out


def _close_params(got, want, step):
    for name, w in want.items():
        # a key bias shifts every logit of a row alike, so its gradient is
        # zero up to rounding and Adam steps it by +-lr on the rounding's
        # sign: only that bound is held (as test_torch_bert.py does)
        tol = 2e-4 * step if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(got[name], w, atol=tol, rtol=0,
                                   err_msg=f"step {step} {name}")


def _same_on_both(a, b, what):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: {k} differs"


# ---------------------------------------------------------------- tests
def test_ranks_take_contiguous_halves(ranks):
    assert ranks[0]["example"]["rows"] == list(range(BATCH // 2))
    assert ranks[1]["example"]["rows"] == list(range(BATCH // 2, BATCH))


@pytest.mark.parametrize("step", range(STEPS))
def test_example_step_matches_the_reference(ranks, jax_example, step):
    """Loss and parameters of each step against the reference's dp step on
    the whole batch; both ranks' parameters bitwise equal."""
    want = jax_example["params"][step]
    for res in ranks:
        ex = res["example"]
        np.testing.assert_allclose(ex["loss"][step],
                                   jax_example["loss"][step], rtol=1e-5)
        # the mean of the ranks' own losses is the global loss
        np.testing.assert_allclose(
            np.mean([r["example"]["local"][step] for r in ranks]),
            jax_example["loss"][step], rtol=1e-5)
        _close_params(ex["params"][step], want, step + 1)
        assert ex["calls"][step] == 1  # the tiny model is one bucket
    _same_on_both(ranks[0]["example"]["params"][step],
                  ranks[1]["example"]["params"][step], f"step {step}")


@pytest.mark.parametrize("step", range(STEPS))
def test_fleet_path_matches_the_reference(ranks, jax_eager, step):
    """distributed_model + distributed_optimizer with the global-norm
    clip, eager: each step's loss and parameters against the JAX eager
    AdamW on the whole batch; both ranks bitwise equal (rank 1's own
    weights were replaced by rank 0's at the wrap)."""
    a, b = ranks[0]["fleet"], ranks[1]["fleet"]
    assert a["types"] == (True, "HybridParallelOptimizer",
                          "HybridParallelClipGrad")
    np.testing.assert_allclose(np.mean([a["local"][step],
                                        b["local"][step]]),
                               jax_eager["loss"][step], rtol=1e-5)
    _close_params(a["params"][step], jax_eager["params"][step], step + 1)
    _same_on_both(a["params"][step], b["params"][step], f"step {step}")
    assert a["buckets"][step] == 1


def test_no_sync_accumulates_then_averages(ranks):
    """Inside ``no_sync`` each rank keeps its own gradient; the next
    ``apply_collective_grads`` outside averages the accumulated ones (the
    sum over the micro-batches, averaged over the ranks)."""
    w = (np.arange(12.0).reshape(3, 4) / 10).astype(np.float32)

    def grad(x):
        y = x @ w.T
        return 2 * y.T @ x, 2 * y.sum(0)

    per_rank = []
    for res in ranks:
        ns = res["no_sync"]
        g0, _ = grad(ns["xs"][0])
        np.testing.assert_allclose(ns["inside"], g0, rtol=1e-5, atol=1e-6)
        per_rank.append([grad(x) for x in ns["xs"]])
    want_w = np.mean([sum(g for g, _ in r) for r in per_rank], axis=0)
    want_b = np.mean([sum(b for _, b in r) for r in per_rank], axis=0)
    for res in ranks:
        np.testing.assert_allclose(res["no_sync"]["after"], want_w,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["no_sync"]["bias_after"], want_b,
                                   rtol=1e-5, atol=1e-6)
        assert res["no_sync"]["buckets"] == 1


def test_buckets_equal_per_tensor_all_reduce_bitwise(ranks):
    for res in ranks:
        bk = res["buckets"]
        assert bk["calls"][0] > 2 and bk["calls"][1] == 1
        for p, s, l in zip(bk["per"], bk["small"], bk["large"]):
            assert np.array_equal(p, s) and np.array_equal(p, l)
    for x, y in zip(ranks[0]["buckets"]["large"],
                    ranks[1]["buckets"]["large"]):
        assert np.array_equal(x, y)


def test_strategy_knobs_and_data_parallel_surface():
    """The reference's strategy fields and defaults; ``DataParallel``
    hands the wrapped model's names through (a world of one)."""
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS

    from paddle_tpu_torch.distributed import (DataParallel,
                                              destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    a, b = DistributedStrategy(), JS()
    for key in ("amp", "amp_configs", "recompute", "recompute_configs",
                "sharding", "sharding_configs", "pipeline",
                "pipeline_configs", "gradient_merge",
                "gradient_merge_configs", "lamb", "dgc",
                "find_unused_parameters", "tensor_parallel",
                "tensor_parallel_configs", "fuse_all_reduce_ops",
                "fuse_grad_size_in_MB", "hybrid_configs"):
        assert getattr(a, key) == getattr(b, key), key
    init_parallel_env(device="cpu")
    try:
        lin = torch.nn.Linear(3, 2)
        dp = DataParallel(lin)
        assert [n for n, _ in dp.named_parameters()] == ["weight", "bias"]
        assert sorted(dp.state_dict()) == ["bias", "weight"]
        assert dp.in_features == 3
        x = torch.ones(1, 3)
        torch.testing.assert_close(dp(x), lin(x))
        dp(x).sum().backward()
        g = lin.weight.grad.clone()
        dp.apply_collective_grads()  # a world of one: unchanged
        assert torch.equal(lin.weight.grad, g)
    finally:
        destroy_process_group()


def test_exit_hook_frees_the_worlds_groups():
    """A world started through ``init_parallel_env`` arms the exit hook.
    After ``torch.distributed``'s own teardown the port still holds the
    world's group, the state in which a gloo thread outlived the world
    into the interpreter's finalization; the hook lets it go."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env, parallel

    group = init_parallel_env(device="cpu")
    assert parallel._exit_hook
    dist.destroy_process_group()
    assert parallel._default_group is group
    parallel._release_at_exit()
    assert parallel._default_group is None
    assert not parallel._env.initialized and not parallel._subgroups
    assert not dist.is_initialized()


def test_new_modules_import_without_jax_or_the_reference():
    """A fresh interpreter imports every module of this slice and the
    example, and finds neither jax nor paddle_tpu loaded."""
    import subprocess
    import sys
    from pathlib import Path

    mods = ["paddle_tpu_torch.distributed.parallel",
            "paddle_tpu_torch.distributed.fleet.meta_optimizers",
            "paddle_tpu_torch.distributed.fleet.utils",
            "paddle_tpu_torch.distributed.fleet.utils.mix_precision_utils",
            "paddle_tpu_torch.distributed.sharding",
            "paddle_tpu_torch.distributed.checkpoint",
            "paddle_tpu_torch.nn.norm"]
    code = ("import importlib, runpy, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "runpy.run_path('examples/train_bert_dp_torch.py', "
            "run_name='not_main')\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"
