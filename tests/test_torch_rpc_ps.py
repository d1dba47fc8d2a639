"""The port's RPC (``distributed/rpc.py``) and parameter server
(``distributed/ps.py``): the reference's process worlds
(``tests/test_rpc_ps.py``: two RPC workers; one server and two trainers
pushing dense and sparse updates) run on the port, rendezvousing through
the port's ``TCPStore``; then the same pushes into the port's and the
reference's ``ParameterServer`` (in-process) give the same tables, dense
and sparse, for sgd, adagrad, adam and geo (f32, within 1e-6: the same
operations in the same order, numpy's against torch's kernels), and the
geo trainer's delta push and merged pull on a port layer.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(script, n, port, timeout=120):
    procs = []
    for rank in range(n):
        env = dict(os.environ, RPC_RANK=str(rank), RPC_WORLD=str(n),
                   RPC_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script.replace("__REPO__", REPO)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}"
    return outs


RPC_SCRIPT = textwrap.dedent("""
    import os, sys, operator
    sys.path.insert(0, "__REPO__")
    from paddle_tpu_torch.distributed import rpc

    rank = int(os.environ["RPC_RANK"])
    world = int(os.environ["RPC_WORLD"])
    ep = "127.0.0.1:" + os.environ["RPC_PORT"]
    me = rpc.init_rpc(f"worker{rank}", rank, world, ep)
    assert me.name == f"worker{rank}" and me.rank == rank
    infos = rpc.get_all_worker_infos()
    assert [w.name for w in infos] == ["worker0", "worker1"]
    if rank == 0:
        assert rpc.rpc_sync("worker1", operator.add, (2, 3)) == 5
        fut = rpc.rpc_async("worker1", operator.mul, (6, 7))
        assert fut.wait() == 42
        try:
            rpc.rpc_sync("worker1", operator.truediv, (1, 0))
        except ZeroDivisionError:
            print("EXC_OK")
        else:
            raise AssertionError("expected ZeroDivisionError")
    rpc.shutdown()
    print("RPC_DONE", rank)
""")


PS_SCRIPT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    sys.path.insert(0, "__REPO__")
    from paddle_tpu_torch.distributed import ps

    rank = int(os.environ["RPC_RANK"])
    world = int(os.environ["RPC_WORLD"])
    ep = "127.0.0.1:" + os.environ["RPC_PORT"]
    role = "PSERVER" if rank == 0 else "TRAINER"
    name = "ps0" if rank == 0 else f"trainer{rank}"
    ps.init_ps(name, rank, world, ep, role=role, lr=0.1, sparse_dim=4)
    if ps.is_server():
        ps.shutdown()
        print("PS_SERVER_DONE")
    else:
        target = torch.tensor([1.0, -2.0, 3.0, 0.5])
        ps.register_dense("w", np.zeros(4, np.float32))
        for _ in range(60):
            w = ps.pull_dense("w")
            assert w.dtype == torch.float32 and w.device.type == "cpu"
            ps.push_dense("w", w - target)      # grad of 0.5*|w-t|^2
        ps.barrier()
        err = float((ps.pull_dense("w") - target).abs().max())
        assert err < 0.05, err
        # rank-disjoint id ranges keep the arithmetic exact while both
        # trainers push into the same table
        ids = np.array([rank * 100, rank * 100 + 1, rank * 100 + 2])
        rows = ps.pull_sparse("emb", ids)
        assert tuple(rows.shape) == (3, 4)
        ps.push_sparse("emb", ids, np.ones((3, 4), np.float32), sync=True)
        torch.testing.assert_close(ps.pull_sparse("emb", ids), rows - 0.1)
        # duplicate ids in one push apply in turn
        before = ps.pull_sparse("emb", [ids[0]])[0]
        ps.push_sparse("emb", [ids[0], ids[0]], torch.ones(2, 4), sync=True)
        torch.testing.assert_close(ps.pull_sparse("emb", [ids[0]])[0],
                                   before - 0.2)
        stats = ps.barrier()
        assert stats["sparse_rows"]["emb"] >= 3
        ps.shutdown()
        print("PS_TRAINER_DONE", rank)
""")


def test_rpc_two_workers():
    outs = _run_world(RPC_SCRIPT, 2, _free_port())
    assert "EXC_OK" in outs[0]
    assert all("RPC_DONE" in o for o in outs)


def test_ps_one_server_two_trainers():
    outs = _run_world(PS_SCRIPT, 3, _free_port())
    assert "PS_SERVER_DONE" in outs[0]
    assert "PS_TRAINER_DONE 1" in outs[1]
    assert "PS_TRAINER_DONE 2" in outs[2]


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "geo"])
def test_server_updates_equal_the_reference(opt):
    """The same registrations and pushes (dense, then sparse with a
    duplicate id and rows made on first touch) into both packages'
    servers: every table equal."""
    from paddle_tpu.distributed.ps import ParameterServer as JaxServer

    from paddle_tpu_torch.distributed.ps import ParameterServer

    rng = np.random.default_rng(3)
    ref = JaxServer(lr=0.05, optimizer=opt, sparse_dim=5)
    port = ParameterServer(lr=0.05, optimizer=opt, sparse_dim=5)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    ref.register_dense("w", w0)
    port.register_dense("w", w0)
    port.register_dense("w", w0 + 1)  # the first registration wins
    for _ in range(4):
        g = rng.standard_normal((3, 4)).astype(np.float32)
        ref.push_dense("w", g)
        port.push_dense("w", torch.from_numpy(g))
    np.testing.assert_allclose(port.pull_dense("w").numpy(),
                               ref.pull_dense("w"), rtol=1e-6, atol=1e-6)
    for ids in ([7, 2, 7], [2, 11], [11, 11, 3]):
        g = rng.standard_normal((len(ids), 5)).astype(np.float32)
        ref.push_sparse("emb", ids, g)
        port.push_sparse("emb", ids, g)
    every = [2, 3, 7, 11, 40]  # 40: made on first touch by this pull
    np.testing.assert_allclose(port.pull_sparse("emb", every).numpy(),
                               ref.pull_sparse("emb", every), rtol=1e-6,
                               atol=1e-6)
    assert port.stats() == ref.stats()


def test_geo_trainer_on_a_port_layer():
    """Two in-process ``GeoTrainer``s over one geo server: local SGD for
    k_steps, then the delta push and the merged pull into the port layer."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.ps import GeoTrainer, ParameterServer

    srv = ParameterServer(optimizer="geo")
    k = 4

    def make_worker(seed):
        torch.manual_seed(0)  # the same init on every worker (geo's rule)
        m = nn.Linear(4, 3, device="cpu")
        opt = optimizer.SGD(learning_rate=0.1,
                            parameters=list(m.named_parameters()))
        geo = GeoTrainer(m, k_steps=k, push=srv.push_dense,
                         pull=srv.pull_dense, register=srv.register_dense)
        return m, opt, geo, np.random.default_rng(seed)

    workers = [make_worker(1), make_worker(2)]
    base = srv.pull_dense("weight")
    syncs = 0
    for _ in range(2 * k):
        for m, opt, geo, rng in workers:
            x = torch.from_numpy(rng.standard_normal((6, 4)).astype(
                np.float32))
            y = torch.from_numpy(rng.integers(0, 3, (6,)))
            loss = torch.nn.functional.cross_entropy(m(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            syncs += geo.maybe_sync()
    assert syncs == 2 * 2  # each worker synced twice, not 2 * k times
    merged = srv.pull_dense("weight")
    assert not torch.allclose(merged, base)  # both deltas landed
    m, _, geo, _ = workers[1]  # the last to sync holds the merged value
    torch.testing.assert_close(m.weight.detach(), merged)
    torch.testing.assert_close(geo._snap["weight"], merged)
