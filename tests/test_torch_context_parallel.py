"""The port's context parallelism (``distributed/fleet/meta_parallel/
context_parallel.py``) across processes, against paddle_tpu's on the
8-device CPU mesh.

Four gloo processes (``torch.multiprocessing``, rendezvous through a file
under the test's tmp dir) each take their shard of the same seeded numpy
inputs: first a world laid out as ``sep=4``, then the same world through
``fleet.init`` as ``dp=2 x sep=2`` (each dp replica on its own batch
element). The shards' outputs and the gradients of ``sum(out * ct)`` are
gathered back and held against ``ring_attention`` / ``ulysses_attention``
of the JAX package (``jax.grad``), whose flash ring runs the Pallas kernels
in interpret mode. The port's flash ring runs the plain twins of the flash
kernels (CPU tensors).

Tolerances: f32 2e-5 (the ring merges chunks in another order than the
reference's scan, and the twins sum in another order than the Pallas
tiles); bf16 3e-2 against the reference's f32-statistics ring on the same
bf16 inputs (P rounded to bf16 in the flash chunks), as the reference's
own bf16 test.
"""
import os

import numpy as np
import pytest
import torch

B, S, H, D = 2, 32, 4, 16
WORLD = 4
SEED = 0

# (name, function, kwargs, dtype, zigzag); run on the sep=4 layout
SEP4 = [
    ("flash_causal", "ring", dict(impl="flash", causal=True), "f32", False),
    ("flash_full", "ring", dict(impl="flash", causal=False), "f32", False),
    ("flash_zigzag", "ring", dict(impl="flash", causal=True), "f32", True),
    ("xla_zigzag", "ring", dict(impl="xla", causal=True), "f32", True),
    ("xla_full", "ring", dict(impl="xla", causal=False), "f32", False),
    ("flash_zigzag_bf16", "ring", dict(impl="flash", causal=True), "bf16",
     True),
    ("ulysses_full", "ulysses", dict(causal=False), "f32", False),
    ("ulysses_causal", "ulysses", dict(causal=True), "f32", False),
]
# run on dp=2 x sep=2 after fleet.init
DP2SEP2 = [
    ("fleet_ring_zigzag", "ring_flash_attention", dict(causal=True), "f32",
     True),
    ("fleet_ulysses_causal", "ulysses", dict(causal=True), "f32", False),
]


def _globals(dtype):
    rng = np.random.default_rng(SEED)
    q, k, v, ct = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    if dtype == "bf16":  # the same bf16 values on both sides
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    return q, k, v, ct


def _zigzag(seq, world):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        zigzag_indices)

    return zigzag_indices(seq, world)


def _run_case(fn, kw, dtype, zigzag, sep, sep_rank, batch):
    """This rank's part of one case: its shard in, its output and the
    gradients of its shard out (numpy, f32)."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.incubate.nn import functional as IF

    q, k, v, ct = _globals(dtype)
    perm = _zigzag(S, sep) if zigzag else np.arange(S)
    sl = S // sep
    rows = perm[sep_rank * sl:(sep_rank + 1) * sl]
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ts = [torch.from_numpy(a[batch][:, rows]).to(tdt).requires_grad_()
          for a in (q, k, v)]
    kw = dict(kw)
    if zigzag:
        pos = torch.from_numpy(rows.astype(np.int32))
        kw.update(q_positions=pos, kv_positions=pos)
    if fn == "ring":
        out = mpar.ring_attention(*ts, **kw)
    elif fn == "ring_flash_attention":
        out = IF.ring_flash_attention(*ts, **kw)
    else:
        out = mpar.ulysses_attention(*ts, **kw)
    assert out.dtype == tdt and out.shape == ts[0].shape
    (out.float() * torch.from_numpy(ct[batch][:, rows])).sum().backward()
    return [out.detach().float().numpy()] + [t.grad.float().numpy()
                                            for t in ts]


def _collectives(rank):
    """The eager collectives on the world and on this rank's sep group of
    the dp=2 x sep=2 mesh (ranks {0, 1} or {2, 3})."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet

    sep = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
    x = torch.full((3,), float(rank + 1))
    out = dict(sum=C.all_reduce(x.clone()).tolist(),
               avg=C.all_reduce(x.clone(), C.ReduceOp.AVG).tolist(),
               sep_max=C.all_reduce(x.clone(), C.ReduceOp.MAX,
                                    group=sep).tolist(),
               gather=[t.tolist() for t in C.all_gather([], x[:1])],
               a2a=[t.tolist() for t in C.all_to_all(
                   [], [torch.tensor([10.0 * rank + j]) for j in range(4)])])
    C.barrier()
    buf = torch.zeros(2)
    if rank % 2 == 0:
        C.send(torch.tensor([rank, 7.0]), rank + 1)
    else:
        C.recv(buf, rank - 1)
    out["recv"] = buf.tolist()
    return out


def _worker(rank, init_file, out_dir):
    from paddle_tpu_torch.distributed import fleet, init_parallel_env
    from paddle_tpu_torch.distributed.topology import build_mesh
    from paddle_tpu_torch.distributed.parallel import set_mesh

    init_parallel_env(device="cpu", init_method=f"file://{init_file}",
                      rank=rank, world_size=WORLD)
    res = {}
    set_mesh(build_mesh(sep=WORLD))
    for name, fn, kw, dtype, zz in SEP4:
        res[name] = _run_case(fn, kw, dtype, zz, WORLD, rank, slice(None))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    dp, sep = hcg.get_data_parallel_rank(), hcg.get_sep_parallel_rank()
    res["topology"] = dict(
        dp_degree=strategy.hybrid_configs["dp_degree"],
        sep_world=hcg.get_sep_parallel_world_size(), dp=dp, sep=sep,
        sep_ranks=hcg.get_sep_parallel_group().ranks,
        worker=(fleet.worker_index(), fleet.worker_num(),
                fleet.is_first_worker()))
    for name, fn, kw, dtype, zz in DP2SEP2:
        res[name] = _run_case(fn, kw, dtype, zz, 2, sep, slice(dp, dp + 1))
    res["collectives"] = _collectives(rank)
    # an unknown impl raises before any communication
    q = torch.zeros((1, 4, H, D))
    try:
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar

        mpar.ring_attention(q, q, q, impl="pallas")
    except ValueError as e:
        res["bad_impl"] = str(e)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Run every case in one world of four gloo processes; returns each
    rank's results."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("ring")
    ctx = mp.start_processes(_worker, args=(str(tmp / "init"), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_case(fn, kw, dtype, zigzag, sep, dp):
    """The reference's output and gradients on the global arrays, in the
    layout order (zig-zag permuted when ``zigzag``)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.fleet.meta_parallel import context_parallel
    from paddle_tpu.distributed.topology import build_mesh

    mesh = build_mesh(sep=sep, dp=dp)
    q, k, v, ct = _globals(dtype)
    perm = _zigzag(S, sep) if zigzag else np.arange(S)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    args = [jnp.asarray(a[:, perm], jdt) for a in (q, k, v)]
    kw = dict(kw)
    if zigzag:
        pos = jnp.asarray(perm, jnp.int32)
        kw.update(q_positions=pos, kv_positions=pos)
    if fn == "ulysses":
        attn = context_parallel.ulysses_attention
    else:
        attn = context_parallel.ring_attention
        kw.setdefault("impl", "flash")

    def loss(a, b, c):
        out = attn(a, b, c, mesh=mesh, **kw)
        return jnp.sum(out.astype(jnp.float32) * ct[:, perm]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _assemble(results, name, shards):
    """Concatenate the ranks' shards: ``shards`` lists, per batch block,
    the ranks holding its sequence slices in order."""
    parts = []
    for i in range(4):
        rows = [np.concatenate([results[r][name][i] for r in ranks], axis=1)
                for ranks in shards]
        parts.append(np.concatenate(rows, axis=0))
    return parts


def _check(got, want, dtype):
    atol = 3e-2 if dtype == "bf16" else 2e-5
    for tag, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=tag)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", SEP4, ids=[c[0] for c in SEP4])
def test_sep4_matches_reference(port_results, case):
    name, fn, kw, dtype, zz = case
    # bf16 against the reference's f32-statistics ring ("xla")
    ref_kw = dict(kw, impl="xla") if dtype == "bf16" else kw
    want = _jax_case(fn, ref_kw, dtype, zz, WORLD, 2)
    got = _assemble(port_results, name, [list(range(WORLD))])
    _check(got, want, dtype)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", DP2SEP2, ids=[c[0] for c in DP2SEP2])
def test_fleet_dp2_sep2_matches_reference(port_results, case):
    name, fn, kw, dtype, zz = case
    ref_fn = "ring" if fn == "ring_flash_attention" else fn
    want = _jax_case(ref_fn, kw, dtype, zz, 2, 4)
    # ranks (dp, sep): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
    got = _assemble(port_results, name, [[0, 1], [2, 3]])
    _check(got, want, dtype)


@pytest.mark.timeout(150)
def test_fleet_topology_collectives_and_refusals(port_results):
    for r, res in enumerate(port_results):
        topo = res["topology"]
        assert topo["dp_degree"] == 2 and topo["sep_world"] == 2
        assert (topo["dp"], topo["sep"]) == divmod(r, 2)
        assert topo["sep_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert topo["worker"] == (r, WORLD, r == 0)
        assert "impl" in res["bad_impl"]
        col = res["collectives"]
        assert col["sum"] == [10.0] * 3 and col["avg"] == [2.5] * 3
        assert col["sep_max"] == [float(2 * (r // 2) + 2)] * 3
        assert col["gather"] == [[1.0], [2.0], [3.0], [4.0]]
        assert col["a2a"] == [[10.0 * i + r] for i in range(WORLD)]
        assert col["recv"] == ([r - 1.0, 7.0] if r % 2 else [0.0, 0.0])


@pytest.mark.timeout(60)
def test_zigzag_indices_match_reference():
    from paddle_tpu.distributed.fleet.meta_parallel import context_parallel

    for seq, world in ((32, 4), (64, 2), (16, 1)):
        np.testing.assert_array_equal(
            _zigzag(seq, world), context_parallel.zigzag_indices(seq, world))
    with pytest.raises(ValueError, match="divide"):
        _zigzag(30, 4)


@pytest.mark.timeout(60)
def test_strategy_degree_checks():
    from paddle_tpu_torch.distributed import fleet

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"sep_degree": 2}
    assert fleet.hybrid_degrees(st.hybrid_configs, 8)["dp_degree"] == 4
    st.hybrid_configs = {"dp_degree": 2, "sep": 2}
    assert fleet.hybrid_degrees(st.hybrid_configs, 4)["dp_degree"] == 2
    with pytest.raises(ValueError, match="do not match"):
        fleet.hybrid_degrees(st.hybrid_configs, 8)  # explicit dp=2
    st.hybrid_configs = {"dp_degree": 1, "sep_degree": 3}
    with pytest.raises(ValueError, match="do not match"):
        fleet.hybrid_degrees(st.hybrid_configs, 4)
    with pytest.raises(ValueError, match="unknown"):
        st.hybrid_configs = {"cp_degree": 2}
    with pytest.raises(TypeError, match="not ported"):
        fleet.distributed_model(None)


@pytest.mark.timeout(60)
def test_topology_matches_reference():
    from paddle_tpu.distributed import topology as jtopo

    from paddle_tpu_torch.distributed import topology as ttopo

    dims = (2, 1, 1, 2, 2)
    a = ttopo.CommunicateTopology(ttopo.HYBRID_AXES, dims)
    b = jtopo.CommunicateTopology(jtopo.HYBRID_AXES, dims)
    for axis in ttopo.HYBRID_AXES:
        assert a.get_comm_list(axis) == b.get_comm_list(axis)
    for rank in range(8):
        ha = ttopo.HybridCommunicateGroup(a, rank)
        hb = jtopo.HybridCommunicateGroup(b, rank)
        assert ha.get_sep_parallel_rank() == hb.get_sep_parallel_rank()
        assert (ha.get_sep_parallel_group().ranks
                == hb.get_sep_parallel_group().ranks)
        assert (ha.get_data_parallel_group().ranks
                == hb.get_data_parallel_group().ranks)
        assert ha.get_data_parallel_rank() == hb.get_data_parallel_rank()


@pytest.mark.timeout(60)
def test_world_teardown_and_reinit():
    """``destroy_process_group`` forgets the world, the mesh and fleet's
    topology, so a second ``fleet.init`` serves a live group; a world torn
    down by torch's own call is noticed too. One gloo rank, in process."""
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention)

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"sep_degree": 1}
    x = torch.from_numpy(_globals("f32")[0][:1])
    try:
        fleet.init(strategy=st, device="cpu")
        first = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
        want = ring_attention(x, x, x, causal=True)
        pdist.destroy_process_group()
        assert not pdist.is_initialized() and not dist.is_initialized()
        with pytest.raises(RuntimeError, match="fleet.init"):
            fleet.get_hybrid_communicate_group()
        fleet.init(strategy=st, device="cpu")
        sep = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
        assert sep.process_group is not first.process_group
        torch.testing.assert_close(ring_attention(x, x, x, causal=True),
                                   want, atol=0, rtol=0)
        dist.destroy_process_group()
        assert not pdist.is_initialized()
        pdist.init_parallel_env(device="cpu")
        mesh = pdist.get_mesh()
        assert mesh is not fleet.fleet_state.mesh and dist.get_backend(
            mesh.get_group("sep")) == "gloo"
        torch.testing.assert_close(ring_attention(x, x, x, causal=True),
                                   want, atol=0, rtol=0)
    finally:
        pdist.destroy_process_group()
