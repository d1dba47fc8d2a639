"""ZeRO of the port (``distributed/sharding``: ``group_sharded_parallel``
at ``os``, ``os_g`` and ``p_g_os``; ``fleet.distributed_optimizer`` at
``sharding_degree > 1``, a ``DygraphShardingOptimizer`` under the
``HybridParallelOptimizer``), after the reference's own
``tests/test_sharding.py`` (``TestShardedOptimizerTwin``,
``TestStage3``): a sharded run matches the plain optimizer on the global
batch, and the state is really sharded.

An MLP (16 -> 64 -> 64 -> 3, ReLU; the last bias, of 3, is indivisible by
2 and stays whole), AdamW(0.01) with ``ClipGradByGlobalNorm(0.5)``, four
steps on a global batch of 8 rows dealt out in equal shares, in one world
of two gloo processes (each level at sharding = 2) and one of four
(``os`` at dp = 2 x sharding = 2 through ``fleet``). Held against the JAX
package's eager AdamW with the same clip on the whole batch: the
parameters within 1e-5 (f32 sums in another order); each rank's
optimizer state is its ``add_sharding_axis`` slice (the reference's rule
on a two-way ``sharding`` mesh), and the slices gathered equal the
reference's moments within 1e-6; the ranks' parameters bitwise equal.
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

DIMS = (16, 64, 64, 3)
STEPS, BATCH, LR, CLIP = 4, 8, 0.01, 0.5
LEVELS = ("os", "os_g", "p_g_os")


def _arrays():
    r = np.random.default_rng(0)
    out = {}
    for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        out[f"{2 * i}.weight"] = (r.standard_normal((a, b))
                                  / np.sqrt(a)).astype(np.float32)
        out[f"{2 * i}.bias"] = (0.1 * r.standard_normal(b)).astype(
            np.float32)
    for s in range(STEPS):
        out[f"x{s}"] = r.standard_normal((BATCH, DIMS[0])).astype(
            np.float32)
        out[f"y{s}"] = r.integers(0, DIMS[-1], (BATCH,)).astype(np.int64)
    return out


def _port_mlp(a):
    from paddle_tpu_torch import nn

    layers = []
    for i, (n_in, n_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(n_in, n_out, device="cpu"))
    model = nn.Sequential(*layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(a[name]))
    return model


def _train(model, opt, a, rows):
    from paddle_tpu_torch.nn import functional as F

    for s in range(STEPS):
        x = torch.from_numpy(a[f"x{s}"][rows])
        y = torch.from_numpy(a[f"y{s}"][rows])
        F.cross_entropy(model(x), y).backward()
        opt.step()
        opt.clear_grad()


def _record(model, opt):
    calls = opt.last_calls  # before state_dict(), which gathers at p_g_os
    sd = model.state_dict()
    return dict(params={k: v.detach().numpy().copy() for k, v in sd.items()},
                state={k: v.numpy().copy() for k, v in
                       opt.state_dict().items()
                       if isinstance(v, torch.Tensor)},
                gathered={k: v.numpy().copy() for k, v in
                          opt.gathered_state_dict().items()
                          if isinstance(v, torch.Tensor)},
                sharded=[(n, d) for n, d, _ in opt.sharded],
                calls=calls)


def _level(a, level, rank, world):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    model = _port_mlp(a)
    opt = optimizer.AdamW(learning_rate=LR,
                          parameters=model.named_parameters(),
                          grad_clip=ClipGradByGlobalNorm(CLIP))

    def shapes():
        return {n: tuple(p.shape) for n, p in model.named_parameters()}

    whole = shapes()
    wrapped, opt, _ = group_sharded_parallel(model, opt, level)
    at_wrap = shapes()
    per = BATCH // world
    _train(wrapped, opt, a, list(range(rank * per, (rank + 1) * per)))
    after = shapes()
    rec = _record(wrapped, opt)
    rec["shapes"] = (whole, at_wrap, after)
    return rec


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    a = dict(np.load(arrays_file))
    res = {}
    if world == 2:
        for level in LEVELS:
            res[level] = _level(a, level, rank, world)
        # under fleet at dp = 2 the default sharding group is the world,
        # which is fleet's dp group too: the gradients are averaged once
        from paddle_tpu_torch.distributed import fleet

        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(),
                   device="cpu")
        res["fleet_dp"] = _level(a, "os_g", rank, world)
    else:
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
        fleet.init(is_collective=True, strategy=st, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        model = _port_mlp(a)
        dp_model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=LR, parameters=model.named_parameters(),
            grad_clip=ClipGradByGlobalNorm(CLIP)))
        per = BATCH // world
        _train(dp_model, opt, a, list(range(rank * per, (rank + 1) * per)))
        res["os"] = _record(model, opt._inner_opt)
        res["types"] = (dp_model is model, type(opt).__name__,
                        type(opt._inner_opt).__name__)
        res["coords"] = (hcg.get_data_parallel_rank(),
                         hcg.get_sharding_parallel_rank())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


def _world(world, arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"zero_world{world}")
    np.savez(tmp / "arrays.npz", **arrays)
    return W.run_world(_worker, world, tmp, str(tmp / "arrays.npz"))


@pytest.fixture(scope="module")
def two(arrays, tmp_path_factory):
    return _world(2, arrays, tmp_path_factory)


@pytest.fixture(scope="module")
def four(arrays, tmp_path_factory):
    return _world(4, arrays, tmp_path_factory)


@pytest.fixture(scope="module")
def reference(arrays):
    """The JAX package's eager AdamW + ClipGradByGlobalNorm on the whole
    batch: its parameters and moments after the steps, and the
    reference's sharding axis for each parameter on a 2-way mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import paddle_tpu as paddle
    from paddle_tpu import nn, optimizer
    from paddle_tpu.distributed.sharding import add_sharding_axis
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm

    layers = []
    for i, (n_in, n_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(n_in, n_out))
    model = nn.Sequential(*layers)
    for name, p in model.named_parameters():
        p.set_value(jnp.asarray(arrays[name]))
    opt = optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                          grad_clip=ClipGradByGlobalNorm(CLIP))
    for s in range(STEPS):
        loss = nn.functional.cross_entropy(
            model(paddle.to_tensor(arrays[f"x{s}"])),
            paddle.to_tensor(arrays[f"y{s}"]))
        loss.backward()
        opt.step()
        opt.clear_grad()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("dp", "sharding"))
    named = list(model.named_parameters())
    return dict(
        params={n: np.asarray(p._data) for n, p in named},
        moments={n: {k: np.asarray(v) for k, v in
                     opt._accumulators[id(p)].items()} for n, p in named},
        specs={n: tuple(add_sharding_axis(tuple(p.shape), None, mesh))
               for n, p in named})


def _check_rank(res, ref, rank, degree):
    for name, want in ref["params"].items():
        np.testing.assert_allclose(res["params"][name], want, atol=1e-5,
                                   rtol=0, err_msg=name)
    dims = dict(res["sharded"])
    for name, spec in ref["specs"].items():
        # the reference's rule: P("sharding") is dim 0, P() replicated
        want_dim = spec.index("sharding") if "sharding" in spec else None
        assert dims.get(name) == want_dim, name
        for k in ("moment1", "moment2"):
            full = ref["moments"][name][k]
            got = res["state"][f"{name}.{k}"]
            gathered = res["gathered"][f"{name}.{k}"]
            np.testing.assert_allclose(gathered, full, atol=1e-6, rtol=0,
                                       err_msg=f"{name}.{k}")
            if want_dim is None:
                assert got.shape == full.shape
                continue
            w = full.shape[want_dim] // degree
            want = np.take(full, range(rank * w, (rank + 1) * w),
                           axis=want_dim)
            assert got.shape == want.shape, (name, got.shape)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("level", LEVELS)
def test_level_matches_the_plain_optimizer(two, reference, level):
    assert "sharding" not in reference["specs"]["4.bias"]  # 3 rows: whole
    for r, res in enumerate(two):
        _check_rank(res[level], reference, r, 2)
    for k, v in two[0][level]["params"].items():
        assert np.array_equal(v, two[1][level]["params"][k]), k


def test_group_sharded_under_fleet_dp(two, reference):
    for r, res in enumerate(two):
        _check_rank(res["fleet_dp"], reference, r, 2)


def test_stage3_holds_slices_between_steps(two):
    """At ``p_g_os`` a rank holds half of every cut parameter from the
    wrap on and between steps; at ``os`` and ``os_g`` the whole one."""
    for level in LEVELS:
        whole, at_wrap, after = two[0][level]["shapes"]
        cut = dict(two[0][level]["sharded"])
        for name, shape in whole.items():
            want = list(shape)
            if level == "p_g_os" and cut.get(name) is not None:
                want[cut[name]] //= 2
            assert at_wrap[name] == after[name] == tuple(want), (level,
                                                                 name)


def test_calls_a_step(two):
    """One bucket holds the whole MLP: ``os`` all-reduces the gradients
    and all-gathers the slices (2 calls); ``os_g`` and ``p_g_os``
    all-reduce the whole 3-bias, reduce-scatter the cut gradients, and
    ``os_g`` all-gathers the slices (3 calls; ``p_g_os`` gathers before
    the next forward instead)."""
    assert two[0]["os"]["calls"] == 2
    assert two[0]["os_g"]["calls"] == 3
    assert two[0]["p_g_os"]["calls"] == 2


def test_dp2_sharding2_through_fleet(four, reference):
    """Four ranks, dp = 2 x sharding = 2: ``distributed_model`` is the
    model itself (its parameters broadcast over dp, as the reference
    returns it), ``distributed_optimizer`` a hybrid optimizer
    over the stage-1 sharded one; every rank matches the plain optimizer
    on the whole batch and holds its sharding slice of the state."""
    for r, res in enumerate(four):
        assert res["types"] == (True, "HybridParallelOptimizer",
                                "DygraphShardingOptimizer")
        dp_rank, sh_rank = res["coords"]
        assert (dp_rank, sh_rank) == divmod(r, 2)
        _check_rank(res["os"], reference, sh_rank, 2)
    for res in four[1:]:
        for k, v in four[0]["os"]["params"].items():
            assert np.array_equal(v, res["os"]["params"][k]), k


@pytest.mark.parametrize("shape,base,sizes,want", [
    ((64, 16), None, {"sharding": 4}, ("sharding",)),
    ((64, 32), (None, "mp"), {"sharding": 2, "mp": 4}, ("sharding", "mp")),
    ((3, 5), None, {"sharding": 4}, ()),
    ((3, 8), None, {"sharding": 4}, (None, "sharding")),
    ((8, 4), ("mp",), {"sharding": 2, "mp": 4}, (("mp", "sharding"),)),
])
def test_add_sharding_axis_matches_the_reference(shape, base, sizes, want):
    """The reference's placement rule and the port's on the same shapes
    (the reference's own four cases and a dim that mp already splits)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.sharding import add_sharding_axis as jadd

    from paddle_tpu_torch.distributed.sharding import add_sharding_axis

    names = ("dp",) + tuple(sizes)
    n = int(np.prod(list(sizes.values())))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(
        (1,) + tuple(sizes.values())), names)
    ref = jadd(shape, None if base is None else P(*base), mesh)
    got = add_sharding_axis(shape, base, sizes)
    assert got == tuple(ref) == want


def test_offload_and_bad_level_raise():
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import (destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    init_parallel_env(device="cpu")
    try:
        lin = nn.Linear(4, 4, device="cpu")
        opt = optimizer.AdamW(parameters=lin.parameters())
        with pytest.raises(ValueError, match="level"):
            group_sharded_parallel(lin, opt, "p_os")
        with pytest.raises(ValueError, match="offload"):
            group_sharded_parallel(lin, opt, "os", offload=True)
    finally:
        destroy_process_group()
