"""Replicas over the port's sharded engine: ``serving.InProcReplica`` over
``Engine(tp=2)``, behind a ``Router`` and a ``ClusterCoordinator``, with
the follower rank in ``serving.follow_replica``.

One world of two gloo processes. Rank 0 holds the router and the
replicas; rank 1 follows each replica on a thread of its own, every
replica on a process group of its own (two groups over ranks 0-1, made
in one order on both ranks). Tiny LLaMA (4 heads, 4 KV heads), f32, the
JAX model's weights.

Held: a replica killed mid-stream (``poison``) loses no token: the
stream migrates to the other replica and ends as the JAX engine's
unkilled stream at tp=None, and the supervisor restarts the victim,
whose follower builds the next incarnation from the same factory and
serves again; a prefill/decode pool of two sharded replicas hands the
prompt's KV from one to the other (exported and adopted as whole pages)
and streams the same tokens; the follower loops return once rank 0
stops the replicas.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD = 2
PROMPT = list(range(1, 21))
GEOM = dict(max_slots=2, num_pages=64, page_size=8)
WAIT = 120


def _cfg():
    from paddle_tpu_torch.models.llama import tiny_llama_config

    return tiny_llama_config(num_heads=4, num_kv_heads=4)


def _groups(n):
    """``n`` process groups over ranks 0-1, made in one order on both."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.topology import Group

    return [Group([0, 1], rank=dist.get_rank(),
                  process_group=dist.new_group([0, 1]))
            for _ in range(n)]


def _factory(arrays, group, **kw):
    """One replica's factory: each incarnation a tp=2 engine over the
    replica's own model (sharded in place by the first) and group."""
    from paddle_tpu_torch.convert import llama_from_numpy
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.serving import ServingFrontend

    model = llama_from_numpy(_cfg(), arrays, device="cpu")

    def factory():
        return ServingFrontend(Engine(model, device="cpu", tp=2,
                                      group=group, **GEOM, **kw))
    return factory


def _wait(pred, timeout_s=WAIT):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _follow(factories):
    """Rank 1: one follow_replica loop a replica, on threads; the number
    of incarnations each followed."""
    from paddle_tpu_torch.serving import follow_replica

    out = [None] * len(factories)

    def run(i):
        out[i] = follow_replica(factories[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(factories))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT * 3)
    return out


def _kill_restart(factories):
    """Rank 0: two replicas, the stream's replica poisoned mid-flight."""
    from paddle_tpu_torch import serving as tsv

    reps = [tsv.InProcReplica(f, name=f"r{i}", index=i)
            for i, f in enumerate(factories)]
    router = tsv.Router(reps, heartbeat_s=0.05, stall_s=None,
                        restart_dead=True, restart_backoff_s=0.05)
    router.start()
    rec = {}
    try:
        t = router.submit(PROMPT, 16)
        assert _wait(lambda: len(t.tokens) >= 4), t.tokens
        rec["before_kill"] = len(t.tokens)
        victim = next(r for r in reps if r.name == t.replica)
        victim.kill()
        rec["tokens"] = t.result(timeout=WAIT)
        rec["reason"] = t.failure_reason
        rec["migrations"] = t.migrations
        rec["restarted"] = _wait(lambda: victim.alive()
                                 and victim.restarts >= 1)
        rec["ready"] = victim.ready()["ready"]
        # the restarted incarnation serves (its follower built it too)
        t2 = router.submit(PROMPT, 16)
        rec["again"] = t2.result(timeout=WAIT)
    finally:
        router.shutdown()
    return rec


def _pooled(factories):
    """Rank 0: a prefill replica and a decode replica, both tp=2."""
    from paddle_tpu_torch import serving as tsv
    from paddle_tpu_torch.observability import metric_total

    reps = [tsv.InProcReplica(f, name=f"p{i}", index=i)
            for i, f in enumerate(factories)]
    router = tsv.Router(reps, heartbeat_s=0.05, stall_s=None,
                        pools={"prefill": 1, "decode": 1})
    router.start()
    names = ("cluster_handoffs", "cluster_handoff_bytes",
             "cluster_fallbacks")
    try:
        assert _wait(lambda: router.cluster._page_size is not None)
        c0 = {k: metric_total(f"paddle_tpu_{k}_total") for k in names}
        t = router.submit(PROMPT, 16)
        rec = dict(tokens=t.result(timeout=WAIT), reason=t.failure_reason,
                   phase=t.phase)
        rec.update({k: metric_total(f"paddle_tpu_{k}_total") - c0[k]
                    for k in names})
    finally:
        router.shutdown()
    return rec


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    arrays = dict(np.load(arrays_file))
    groups = _groups(4)
    slow = "slow-step:every=1,delay_ms=30"
    kill = [_factory(arrays, g, chunk_size=1, max_chain=1, fault_plan=slow)
            for g in groups[:2]]
    pool = [_factory(arrays, g, chunk_size=4, prefix_cache=True)
            for g in groups[2:]]
    if rank == 0:
        res = dict(kill=_kill_restart(kill), pooled=_pooled(pool))
    else:
        res = dict(kill=_follow(kill), pooled=_follow(pool))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM, tiny_llama_config

    paddle.seed(0)
    jm = LlamaForCausalLM(tiny_llama_config(num_heads=4, num_kv_heads=4))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def reference(jax_model):
    """PROMPT's unkilled greedy stream on the JAX engine at tp=None."""
    import jax.numpy as jnp

    from paddle_tpu.inference.engine import Engine as JaxEngine

    eng = JaxEngine(jax_model, dtype=jnp.float32, metrics=False,
                    chunk_size=4, **GEOM)
    req = eng.add_request(np.asarray(PROMPT, np.int32), 16)
    eng.run()
    assert req.done and not req.failed
    return list(req.tokens)


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):
    from paddle_tpu.jit import param_arrays

    tmp = tmp_path_factory.mktemp("tp_replicas")
    arrays = tmp / "arrays.npz"
    np.savez(arrays, **{k: np.asarray(v)
                        for k, v in param_arrays(jax_model).items()})
    return W.run_world(_worker, WORLD, tmp, str(arrays))


def test_killed_replica_migrates_and_restarts(port, reference):
    rec = port[0]["kill"]
    assert rec["before_kill"] < 16
    assert rec["tokens"] == reference and rec["reason"] is None
    assert rec["migrations"] >= 1
    assert rec["restarted"] and rec["ready"]
    assert rec["again"] == reference


def test_follower_builds_each_incarnation(port):
    """The victim's follower followed two incarnations (the restart), the
    other replica's one; both loops returned when rank 0 stopped them."""
    assert sorted(port[1]["kill"]) == [1, 2]


def test_pooled_handoff_between_sharded_replicas(port, reference):
    rec = port[0]["pooled"]
    assert rec["tokens"] == reference and rec["reason"] is None
    assert rec["phase"] == "decode"
    assert rec["cluster_handoffs"] == 1 and rec["cluster_fallbacks"] == 0
    assert rec["cluster_handoff_bytes"] > 0
    assert port[1]["pooled"] == [1, 1]
