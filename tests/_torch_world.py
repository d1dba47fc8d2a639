"""What the port's multi-process CPU tests share: a world of gloo processes
(``torch.multiprocessing``, spawned, a ``file://`` rendezvous under the
test's tmp dir) that runs a worker function once per rank, joined with a
deadline (a hang fails the test and kills the ranks), and the serving
scenarios that the tensor- and expert-parallel suites run on both the JAX
engine and the port's sharded engines.

A scenario is a list of engine runs: each builds one engine from
keyword arguments and runs a body on it (requests in, streams out). On a
sharded port engine the body runs on the engine's rank 0 only; every
other rank builds the same engine and runs its follower loop
(``Engine.run``) until rank 0 closes it. Every rank records the outputs
of every command it runs, so a test can hold each follower's outputs
against rank 0's, bit for bit.
"""
import datetime
import os
import time

import numpy as np
import torch

DEADLINE_S = 420


def run_world(worker, world, tmp, *args, deadline_s=DEADLINE_S):
    """Run ``worker(rank, world, init_file, out_dir, *args)`` in ``world``
    spawned processes; each rank saves ``rank{r}.pt`` in ``out_dir``.
    Returns the ranks' results. Fails if a rank exits non-zero or the
    world outlives ``deadline_s``."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    ctx = mp.start_processes(worker, args=(world, os.path.join(tmp, "init"),
                                           tmp) + tuple(args),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() - t0 > deadline_s:
                raise AssertionError(
                    f"the {world}-rank world hung past {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def init_world(rank, world, init_file):
    """This rank's gloo world (a 120 s bound on every collective's wait)."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import init_parallel_env

    init_parallel_env(device="cpu", init_method=f"file://{init_file}",
                      rank=rank, world_size=world,
                      timeout=datetime.timedelta(seconds=120))


def synthetic_clock(eng):
    """Feed ``eng``'s measured boundary cost the same step time ``3 + 2k``
    on every engine in place of the wall: chain depths follow the cost,
    and the schedule with them."""
    observe = eng._observe_chain_time
    eng._observe_chain_time = lambda nb, k, wall: observe(nb, k,
                                                          3.0 + 2.0 * k)
    return eng


GEOM = dict(max_slots=2, num_pages=64, page_size=8, chunk_size=4,
            max_chain=2)


# ------------------------------------------------------------ bodies
def body_serve(eng, vocab, n_req=4, budget=8, temps=(0.0,), seed=3):
    """The reference suites' ``serve``: ``n_req`` prompts of 6-19 tokens
    from ``seed``, ``budget`` tokens each, temperatures in turn."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        p = rng.integers(0, vocab, (int(rng.integers(6, 20)),))
        reqs.append(eng.add_request(p, budget,
                                    temperature=temps[i % len(temps)]))
    eng.run()
    return reqs


def body_templated(eng, vocab):
    """The reference's prefix-cache workload: two passes of four prompts
    that share a 24-token template, each run to completion."""
    tpl = np.random.default_rng(9).integers(0, vocab, (24,))
    reqs = []
    for pas in range(2):
        for i in range(4):
            tail = np.random.default_rng(100 + 10 * pas + i).integers(
                0, vocab, (5,))
            reqs.append(eng.add_request(np.concatenate([tpl, tail]), 6))
        eng.run()
    return reqs


def body_churn(eng, vocab, rounds=2, budget=4, n_tpl=6, tlen=48, tail=5):
    """The host tier's workload (the reference's ``tests/test_kv_tier.py``
    churn): round-robin visits of ``n_tpl`` templates of ``tlen`` tokens
    with distinct tails, two steps after each arrival; a pool of about two
    templates demotes and promotes the rest every round."""
    r = np.random.default_rng(3)
    tpls = [r.integers(0, vocab, (tlen,)) for _ in range(n_tpl)]
    reqs, n = [], 0
    for _ in range(rounds):
        for tpl in tpls:
            n += 1
            tl = np.random.default_rng(1000 + n).integers(0, vocab, (tail,))
            reqs.append(eng.add_request(np.concatenate([tpl, tl]), budget))
            eng.step()
            eng.step()
    eng.run()
    return reqs


BODIES = {"serve": body_serve, "templated": body_templated,
          "churn": body_churn}


def outcome(eng, reqs):
    """What a test compares of a finished run."""
    pc = getattr(eng, "_pcache", None)
    return dict(tokens=[list(map(int, r.tokens)) for r in reqs],
                reasons=[r.failure_reason for r in reqs],
                retries=[int(r.retries) for r in reqs],
                hits=None if pc is None else int(pc.hits),
                fault=eng._watchdog.last_fault is not None)


# -------------------------------------------------------- port worker
def record_commands(eng):
    """Every command output this rank keeps, in order (tensors cloned)."""
    log = []
    keep = eng.runner._keep

    def rec(seq, out):
        outs = out if isinstance(out, (tuple, list)) else (
            () if out is None else (out,))
        log.append([t.detach().clone() for t in outs
                    if isinstance(t, torch.Tensor)])
        keep(seq, out)

    eng.runner._keep = rec
    return log


def dying_decode(eng):
    """Rank 0's first decode dispatch raises before its command goes out
    (the reference suite's dying ``_get_decode``)."""
    orig = eng.runner.get_decode
    state = {"armed": True}

    def get_decode(nb, k, sampling):
        fn = orig(nb, k, sampling)

        def wrapper(*a):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected dispatch death")
            return fn(*a)

        return wrapper

    eng.runner.get_decode = get_decode
    return state


def port_serve(rank, ranks, model_fn, vocab, case):
    """One scenario on the port: an engine over the subgroup
    ``ranks`` (this rank must be in it) built by ``model_fn()`` and
    ``case["kw"]``; rank 0 of the group runs the body. Returns this rank's
    record."""
    from paddle_tpu_torch.distributed.parallel import subgroup
    from paddle_tpu_torch.inference.engine import Engine

    group = subgroup(ranks)
    kw = dict(GEOM, device="cpu", dtype=torch.float32)
    kw.update(case.get("kw", {}))
    eng = Engine(model_fn(), group=group, **kw)
    log = record_commands(eng)
    rec = dict(log=log, pool=tuple(eng._cache.k_pages[0].shape),
               specs=dict(eng.runner.param_specs or {}))
    if eng.is_leader:
        synthetic_clock(eng)
        state = dying_decode(eng) if case.get("fault") == "decode" else None
        reqs = BODIES[case.get("body", "serve")](
            eng, vocab, **case.get("body_kw", {}))
        rec.update(outcome(eng, reqs))
        if state is not None:
            rec["fault_fired"] = not state["armed"]
        stats = eng.moe_stats() if eng._moe_stats_n else None
        rec["moe"] = stats
        eng.close()
    else:
        assert eng.run() == []
    return rec


def jax_serve(jm, case, tp=None, ep=None):
    """The same scenario on the JAX engine (f32, metrics off, the synthetic
    clock); ``fault`` scenarios run fault-free there, as the reference
    suite compares a recovered stream with the clean one."""
    import jax.numpy as jnp

    from paddle_tpu.inference.engine import Engine as JaxEngine

    kw = dict(GEOM, dtype=jnp.float32, metrics=False)
    kw.update(case.get("kw", {}))
    eng = synthetic_clock(JaxEngine(jm, tp=tp, ep=ep, **kw))
    reqs = BODIES[case.get("body", "serve")](
        eng, jm.config.vocab_size, **case.get("body_kw", {}))
    out = outcome(eng, reqs)
    out["moe"] = eng.moe_stats() if getattr(eng, "_moe_stats_n", 0) \
        else None
    return out


def same_log(a, b):
    """Two ranks' command outputs are equal, bit for bit."""
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert len(x) == len(y), i
        for s, t in zip(x, y):
            assert s.dtype == t.dtype and torch.equal(s, t), \
                f"command {i} differs"


def same_stats(got, want):
    """Router stats: the counts exactly, the entropy sum within 1e-5 (f32
    sums in another order), as ``test_torch_moe.py`` holds them."""
    assert got["tokens_routed"] == want["tokens_routed"] > 0
    for key in ("pairs_dropped", "expert_load", "pairs_kept"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["router_entropy"],
                               want["router_entropy"], rtol=1e-5)
