"""The port's expert-parallel serving (``Engine(ep=)``, and ``tp=2 x
ep=2``, over ``torch.distributed``, one process a rank) against
paddle_tpu's engine on the tiny MoE LLaMA (8 experts, top-2), f32, the
same weights on both sides.

One world of four gloo processes runs every case: the ep=2 runs on
two engines at once (ranks 0-1 and 2-3), then ep=4 and tp=2 x ep=2 over
the whole world. The scenarios are the reference suite's
(``tests/test_moe_serving.py``): greedy and sampled, chunked prefill,
n-gram speculative decoding, recompute preemption under a 9-page pool,
and capacity overload (``capacity_factor=0.5``, heavy dropping). The JAX
side runs its grouped expert matmul through ``grouped_matmul_ref``, as
``test_torch_moe.py`` does (a module-scoped patch of the attribute on its
module; nothing in ``paddle_tpu`` changes).

Held: rank 0's streams, failure reasons and router stats
(``moe_stats()``: the routing is replicated, so the drop set is ep=1's)
equal the JAX engine's at ep=None; every follower's command outputs equal
rank 0's bit for bit; one scenario also equals the JAX engine at ep=2;
the expert stacks split over ep while the router stays whole.
"""
import os
import sys

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD = 4
HALVES = ([0, 1], [2, 3])
SCENARIOS = {
    "greedy_sampled": dict(body_kw=dict(temps=(0.0, 0.7))),
    "chunked": dict(kw=dict(prefill_chunk=4)),
    "spec_ngram": dict(kw=dict(spec="ngram", spec_k=4)),
    "preemption": dict(kw=dict(num_pages=9),
                       body_kw=dict(n_req=3, budget=24)),
    "overload": dict(kw=dict(capacity_factor=0.5)),
}
# (layout, scenarios) over the whole world
WHOLE = {"ep4": (dict(ep=4), ("greedy_sampled", "overload",
                              "preemption")),
         "tp2ep2": (dict(tp=2, ep=2), ("greedy_sampled", "chunked",
                                       "spec_ngram"))}


def _cfg():
    from paddle_tpu_torch.models.llama import tiny_moe_llama_config

    return tiny_moe_llama_config()


def _worker(rank, world, init_file, out_dir, arrays_file):
    from paddle_tpu_torch.convert import llama_from_numpy

    W.init_world(rank, world, init_file)
    arrays = dict(np.load(arrays_file))
    cfg = _cfg()

    def model_fn():
        return llama_from_numpy(cfg, arrays, device="cpu")

    res = {}
    names = list(SCENARIOS)
    for name in names[rank // 2::2]:
        case = dict(SCENARIOS[name])
        case["kw"] = dict(case.get("kw", {}), ep=2)
        res[("ep2", name)] = W.port_serve(rank, HALVES[rank // 2],
                                            model_fn, cfg.vocab_size, case)
    for layout, (kw, scen) in WHOLE.items():
        for name in scen:
            case = dict(SCENARIOS[name])
            case["kw"] = dict(case.get("kw", {}), **kw)
            res[(layout, name)] = W.port_serve(
                rank, list(range(world)), model_fn, cfg.vocab_size, case)
    res["replica_tp2ep2"] = _replica_refusal(rank, model_fn)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def _replica_refusal(rank, model_fn):
    """An ``InProcReplica`` over a tp=2 x ep=2 engine of the whole world:
    rank 0 starts it, the others follow it; what each raised."""
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.serving import (InProcReplica, ServingFrontend,
                                          follow_replica)

    def factory():
        return ServingFrontend(Engine(model_fn(), tp=2, ep=2,
                                      **dict(W.GEOM, device="cpu")))
    try:
        if rank == 0:
            InProcReplica(factory).start()
        else:
            follow_replica(factory)
    except Exception as e:  # noqa: BLE001 - the class is what is held
        return type(e).__name__, str(e)
    return None


@pytest.fixture(scope="module")
def jax_model():
    import paddle_tpu as paddle
    import paddle_tpu.ops.pallas.grouped_matmul  # noqa: F401
    from paddle_tpu.models import llama as jllama

    mod = sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]
    kept = mod.grouped_matmul
    mod.grouped_matmul = mod.grouped_matmul_ref
    try:
        paddle.seed(0)
        jm = jllama.LlamaForCausalLM(jllama.tiny_moe_llama_config())
        jm.eval()
        yield jm
    finally:
        mod.grouped_matmul = kept


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):
    from paddle_tpu.jit import param_arrays

    tmp = tmp_path_factory.mktemp("ep_world")
    arrays = tmp / "arrays.npz"
    np.savez(arrays, **{k: np.asarray(v)
                        for k, v in param_arrays(jax_model).items()})
    return W.run_world(_worker, WORLD, tmp, str(arrays))


@pytest.fixture(scope="module")
def jax_base(jax_model):
    return {name: W.jax_serve(jax_model, case)
            for name, case in SCENARIOS.items()}


def _records(port, layout, name):
    if layout == "ep2":
        half = HALVES[list(SCENARIOS).index(name) % 2]
        recs = [port[r][("ep2", name)] for r in half]
    else:
        recs = [port[r][(layout, name)] for r in range(WORLD)]
    return recs[0], recs[1:]


CASES = [("ep2", n) for n in SCENARIOS] + [
    (layout, n) for layout, (_, scen) in WHOLE.items() for n in scen]


@pytest.mark.parametrize("layout,name", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_streams_and_stats_equal_jax_unsharded(port, jax_base, layout,
                                               name):
    lead, followers = _records(port, layout, name)
    want = jax_base[name]
    assert lead["tokens"] == want["tokens"]
    assert lead["reasons"] == want["reasons"]
    W.same_stats(lead["moe"], want["moe"])
    if name == "preemption":
        assert any(lead["retries"]), "the pool did not preempt"
    if name == "overload":
        assert lead["moe"]["drop_frac"] > 0.2
    for rec in followers:
        W.same_log(rec["log"], lead["log"])


def test_ep2_equals_jax_ep2(port, jax_model, jax_base):
    """One scenario against the JAX engine sharded over ep=2 (its
    all_to_all / all_gather program on the 8-device CPU mesh): the same
    streams. Its router stats at ep=2 are not its own ep=None stats (more
    pairs counted, more drops); the port's are, as the reference's
    replicated-routing contract says (ROADMAP queue C)."""
    want = W.jax_serve(jax_model, SCENARIOS["greedy_sampled"], ep=2)
    lead, _ = _records(port, "ep2", "greedy_sampled")
    assert lead["tokens"] == want["tokens"]
    W.same_stats(lead["moe"], jax_base["greedy_sampled"]["moe"])


@pytest.mark.parametrize("layout", ["ep2", "ep4", "tp2ep2"])
def test_expert_stacks_sharded_router_replicated(port, layout):
    lead, followers = _records(port, layout, "greedy_sampled")
    specs = lead["specs"]
    assert specs["model.layers.0.mlp.experts_gate"] == ("ep", None, None)
    assert specs["model.layers.0.mlp.router.weight"] == ()
    cfg = _cfg()
    tp = 2 if layout == "tp2ep2" else 1
    lanes = cfg.num_kv_heads * cfg.head_dim // tp
    for rec in [lead] + followers:
        assert rec["pool"][-1] == lanes


def test_replica_refused_at_tp2_ep2(port):
    """A replica rides tp or ep alone: over a tp=2 x ep=2 engine rank 0's
    ``start()`` and every follower's ``follow_replica`` raise TypeError
    naming the shared tp and ep groups (two replicas over the same ranks
    would mix their collectives), and every rank leaves the engine."""
    for r in range(WORLD):
        cls, msg = port[r]["replica_tp2ep2"]
        assert cls == "TypeError", (r, cls, msg)
        assert "tp=2 x ep=2" in msg and "share" in msg, msg
