"""The port's tensor-parallel serving (``Engine(tp=)`` over
``torch.distributed``, one process a rank) against paddle_tpu's engine.

One world of four gloo processes runs every case of this file: the tp=2
runs on two engines at once (ranks 0-1 and 2-3, each pair a group of
its own), then the tp=4 runs over the whole world, then the
mechanics. The scenarios are the reference suite's
(``tests/test_tp_serving.py``): greedy and sampled, chunked prefill with
and without ``disaggregate``, n-gram speculative decoding, the prefix
cache on and off over a templated two-pass workload, recovery from a
decode dispatch that dies before its command goes out, and a
``nan-logits`` fault inside a disaggregated step. Tiny LLaMA (4 heads, 4
KV heads), f32, the same weights on both sides.

Held: rank 0's token streams (and failure reasons, and the prefix cache's
hits) equal the JAX engine's at tp=None; every follower's command outputs
equal rank 0's bit for bit (the ranks sample from the same logits); one
scenario also equals the JAX engine at tp=2 (its 8-device CPU mesh);
each rank's pool holds its ``Hkv/tp`` heads' lanes; the watchdog's batch
shrink stays on the tp quantum; the reference's validation errors.
"""
import os

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
    "chunked_disagg": dict(kw=dict(prefill_chunk=4, disaggregate=True)),
    "spec_ngram": dict(kw=dict(spec="ngram", spec_k=4)),
    "prefix_on": dict(kw=dict(prefix_cache=True), body="templated"),
    "prefix_off": dict(kw=dict(prefix_cache=False), body="templated"),
    "step_fault": dict(fault="decode"),
    "nan_disagg": dict(kw=dict(prefill_chunk=4, disaggregate=True,
                               fault_plan="nan-logits:rid=2,times=1")),
}
TP4 = ("greedy_sampled", "chunked_disagg", "spec_ngram", "prefix_on",
       "step_fault")


def _cfg():
    from paddle_tpu_torch.models.llama import tiny_llama_config

    return tiny_llama_config(num_heads=4, num_kv_heads=4)


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is held
        return type(e).__name__, str(e)
    return None


def _mechanics(rank, ranks, arrays):
    """Validation errors (every rank: nothing communicates before them)
    and, on the group ``ranks``, the watchdog's shrink."""
    from paddle_tpu_torch.convert import llama_from_numpy
    from paddle_tpu_torch.distributed.parallel import subgroup
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               tiny_moe_llama_config)

    def model():
        return llama_from_numpy(_cfg(), arrays, device="cpu")

    kw = dict(W.GEOM, device="cpu")
    out = {}
    group = subgroup(ranks)
    out["tp3"] = _errors(lambda: Engine(model(), tp=3, **kw))
    out["quant"] = _errors(lambda: Engine(model(), tp=2, group=group,
                                          quantized_cache=True, **kw))
    gcfg = GPTConfig(hidden_size=32, num_layers=1, num_heads=2,
                     max_position=64, vocab_size=64)
    gpt = GPTForCausalLM(gcfg, device="cpu")
    out["gpt"] = _errors(lambda: Engine(gpt, tp=2, group=group, **kw))
    out["dense_ep"] = _errors(lambda: Engine(model(), ep=2, group=group,
                                             **kw))
    moe = tiny_moe_llama_config(num_heads=4, num_kv_heads=4)
    out["ep3"] = _errors(lambda: Engine(LlamaForCausalLM(moe, device="cpu"),
                                        ep=3, **kw))
    out["too_big"] = _errors(lambda: Engine(model(), tp=4, ep=2, **kw))
    out["disagg"] = _errors(lambda: Engine(model(), tp=2, group=group,
                                           disaggregate=True, **kw))
    eng = Engine(model(), tp=2, group=group, **dict(kw, max_slots=6))
    if eng.is_leader:
        wd = eng._watchdog
        wd.level = 2
        wd._apply()
        shrunk = eng._slot_cap
        wd.level = 0
        wd._apply()
        out["shrink"] = (shrunk, eng._batch_quantum, eng._slot_cap,
                         eng.max_slots)
        eng.close()
    else:
        eng.run()
    return out


def _worker(rank, world, init_file, out_dir, arrays_file):
    from paddle_tpu_torch.convert import llama_from_numpy

    W.init_world(rank, world, init_file)
    arrays = dict(np.load(arrays_file))
    cfg = _cfg()

    def model_fn():
        return llama_from_numpy(cfg, arrays, device="cpu")

    res = {}
    half = HALVES[rank // 2]
    names = list(SCENARIOS)
    for name in names[rank // 2::2]:
        case = dict(SCENARIOS[name])
        case["kw"] = dict(case.get("kw", {}), tp=2)
        res[("tp2", name)] = W.port_serve(rank, half, model_fn,
                                            cfg.vocab_size, case)
    for name in TP4:
        case = dict(SCENARIOS[name])
        case["kw"] = dict(case.get("kw", {}), tp=4)
        res[("tp4", name)] = W.port_serve(rank, list(range(world)),
                                            model_fn, cfg.vocab_size, case)
    res["mechanics"] = _mechanics(rank, half, arrays)
    if rank < 2:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        return
    # last, on ranks 2-3: the follower's decode program raises; it exits
    # (its sockets close) and rank 0's run fails naming its error
    from paddle_tpu_torch.distributed.parallel import subgroup
    from paddle_tpu_torch.inference.engine import Engine

    eng = Engine(model_fn(), tp=2, group=subgroup(half),
                 **dict(W.GEOM, device="cpu"))
    if eng.is_leader:
        try:
            W.body_serve(eng, cfg.vocab_size)
            res["follower_fault"] = None
        except Exception as e:  # noqa: BLE001 - what rank 0 raised
            res["follower_fault"] = (type(e).__name__, str(e))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        return
    prog = eng.runner.get_decode(2, 2, False)

    def boom(*a):
        raise RuntimeError("follower boom")

    prog.fn = boom
    try:
        eng.run()
    except Exception as e:  # noqa: BLE001
        res["follower_fault"] = (type(e).__name__, str(e))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    os._exit(0)


@pytest.fixture(scope="module")
def jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu.models.llama import tiny_llama_config

    paddle.seed(0)
    jm = LlamaForCausalLM(tiny_llama_config(num_heads=4, num_kv_heads=4))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def port(jax_model, tmp_path_factory):
    from paddle_tpu.jit import param_arrays

    tmp = tmp_path_factory.mktemp("tp_world")
    arrays = tmp / "arrays.npz"
    np.savez(arrays, **{k: np.asarray(v)
                        for k, v in param_arrays(jax_model).items()})
    return W.run_world(_worker, WORLD, tmp, str(arrays))


@pytest.fixture(scope="module")
def jax_base(jax_model):
    return {name: W.jax_serve(jax_model, case)
            for name, case in SCENARIOS.items()}


def _records(port, tp, name):
    """(rank 0's record, the followers' records) of one run."""
    if tp == 2:
        half = HALVES[list(SCENARIOS).index(name) % 2]
        recs = [port[r][("tp2", name)] for r in half]
    else:
        recs = [port[r][("tp4", name)] for r in range(WORLD)]
    return recs[0], recs[1:]


CASES = [(2, n) for n in SCENARIOS] + [(4, n) for n in TP4]


@pytest.mark.parametrize("tp,name", CASES,
                         ids=[f"tp{t}-{n}" for t, n in CASES])
def test_streams_equal_jax_unsharded(port, jax_base, tp, name):
    lead, followers = _records(port, tp, name)
    want = jax_base[name]
    assert lead["tokens"] == want["tokens"]
    assert lead["reasons"] == want["reasons"]
    if name.startswith("prefix"):
        assert lead["hits"] == want["hits"]
    if name == "prefix_on":
        assert lead["hits"] > 0  # the sharded pool served splices
    if name == "step_fault":
        assert lead["fault_fired"] and lead["fault"]
    if name == "nan_disagg":
        # rid 2 failed, its batchmates streamed
        assert lead["reasons"][2] is not None
        assert lead["reasons"][:2] == [None, None]
    for rec in followers:
        W.same_log(rec["log"], lead["log"])
    assert len(lead["log"]) > 0


def test_tp2_equals_jax_tp2(port, jax_model):
    """One scenario against the JAX engine sharded the same way (its
    shard_map programs on the 8-device CPU mesh)."""
    want = W.jax_serve(jax_model, SCENARIOS["greedy_sampled"], tp=2)
    lead, _ = _records(port, 2, "greedy_sampled")
    assert lead["tokens"] == want["tokens"]


@pytest.mark.parametrize("tp", [2, 4])
def test_pool_and_params_sharded(port, tp):
    """Each rank's pool holds its Hkv/tp heads' lanes of every page; the
    projections carry the reference's column and row specs."""
    lead, followers = _records(port, tp, "greedy_sampled")
    cfg = _cfg()
    lanes = cfg.num_kv_heads * cfg.head_dim // tp
    for rec in [lead] + followers:
        assert rec["pool"] == (W.GEOM["num_pages"], W.GEOM["page_size"],
                               lanes)
    specs = lead["specs"]
    assert specs["model.layers.0.self_attn.q_proj.weight"] == (None, "tp")
    assert specs["model.layers.0.self_attn.o_proj.weight"] == ("tp", None)
    assert specs["model.layers.0.mlp.down_proj.weight"] == ("tp", None)
    assert specs["lm_head.weight"] == ()


def test_watchdog_batch_shrink_on_quantum(port):
    shrunk, quantum, restored, max_slots = port[0]["mechanics"]["shrink"]
    assert quantum == 2
    assert shrunk % quantum == 0 and shrunk <= max_slots
    assert restored == max_slots


@pytest.mark.parametrize("case,cls,key", [
    ("tp3", "ValueError", "num_heads"),
    ("quant", "NotImplementedError", "quantized"),
    ("gpt", "NotImplementedError", "packed-QKV"),
    ("dense_ep", "ValueError", "dense model"),
    ("ep3", "ValueError", "must divide num_experts"),
    ("too_big", "ValueError", "needs 8 ranks"),
    ("disagg", "ValueError", "disaggregate"),
])
def test_validation_errors(port, case, cls, key):
    """The reference's exception classes and message keys, raised on every
    rank before anything communicates."""
    for r in range(WORLD):
        got = port[r]["mechanics"][case]
        assert got is not None and got[0] == cls and key in got[1], got


def test_serve_example_spawns_tp_ranks():
    """``examples/serve_llama_paged_torch.py --tp 2`` (and ``--tp 2 --ep
    2``): the ranks are spawned, rank 0 serves the demo's six requests to
    completion, the follower returns."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for extra in (["--tp", "2"], ["--tp", "2", "--ep", "2"]):
        out = subprocess.run(
            [sys.executable, os.path.join(root, "examples",
                                          "serve_llama_paged_torch.py"),
             "--tiny", "--device", "cpu"] + extra,
            capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.count("tokens (streamed") == 6, out.stdout
        assert "pool fully recycled" in out.stdout


def test_follower_exception_fails_rank0_run(port):
    """A follower whose command raises writes its error to the world's
    store and raises; its process ends, and rank 0's run fails with
    ``ShardedEngineError`` naming the follower's error (a failed run, not
    a silent stop or a hang)."""
    lead, follower = port[2]["follower_fault"], port[3]["follower_fault"]
    assert follower[0] == "ShardedEngineError"
    assert "follower boom" in follower[1]
    assert lead is not None and lead[0] == "ShardedEngineError"
    assert "follower boom" in lead[1] and "rank 3" in lead[1]


@pytest.mark.parametrize("tp,ep", [(2, 1), (4, 1), (1, 2), (2, 2)])
def test_shard_state_dict_concatenates_to_full(tp, ep):
    """``convert.shard_state_dict`` by the serving plan: every rank's
    shards of the JAX parameters, concatenated along each split dim, are
    the parameters; the whole ones are equal on every rank."""
    import paddle_tpu as paddle
    from paddle_tpu.jit import param_arrays
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu.models.llama import tiny_moe_llama_config

    from paddle_tpu_torch.convert import shard_state_dict
    from paddle_tpu_torch.inference.runner import serving_spec

    paddle.seed(0)
    full = {k: np.asarray(v) for k, v in param_arrays(LlamaForCausalLM(
        tiny_moe_llama_config(num_heads=4, num_kv_heads=4))).items()}
    shards = {(i, j): shard_state_dict(full, tp=tp, ep=ep, tp_rank=i,
                                       ep_rank=j)
              for i in range(tp) for j in range(ep)}
    split = 0
    for name, arr in full.items():
        spec = serving_spec(name, arr.shape, tp, ep)
        if not spec:
            for sd in shards.values():
                np.testing.assert_array_equal(sd[name], arr)
            continue
        split += 1
        axis = next(a for a in spec if a)
        dim = spec.index(axis)
        n = tp if axis == "tp" else ep
        parts = [shards[(r, 0) if axis == "tp" else (0, r)][name]
                 for r in range(n)]
        assert all(p.shape[dim] == arr.shape[dim] // n for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=dim), arr)
    assert split > 0
