"""The serving options of the port's sharded engine (``Engine(tp=2)`` and
``Engine(ep=2)``, one process a rank over ``torch.distributed``) against
paddle_tpu's engine: the host KV tier, the integrity sentinel, the KV
handoff and ``spec="draft"``.

One world of two gloo processes runs every case of this file, on tiny
LLaMA (4 heads, 4 KV heads) at tp=2 and its MoE twin (8 experts) at ep=2,
f32, the same weights on both sides. The reference serves each option at
tp=2 with the streams of its tp=None engine, and with the option off
(greedy spec, the tier, the sentinel change no token), so rank 0's
streams are held against the JAX engine at tp=None.

Held, besides the streams: every follower's command outputs equal rank
0's bit for bit; the sentinel's page sums at tp=2 equal the tp=None
checksum of the same pages whole, bit for bit; a
``bit-flip-weight`` in the follower's shard quarantines rank 0's engine,
naming the rank; the strict shadow recompute runs at tp=2; a handoff
payload exported at tp=2 is the tp=None engine's, byte for byte, and a
tp=2 -> tp=None -> tp=2 round trip gives the stream without handoff; the
tier demotes and promotes, and a ``kv-spill-corrupt`` in the follower's
lanes is contained; no follower builds the draft; one scenario equals the
JAX engine at tp=2 on its 8-device CPU mesh; weight-only quantized layers
stay refused at tp=2, while the reference's tp=2 engine fails every
request of such a model with ``RetriesExhausted``.
"""
import os
import sys

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD = 2
RANKS = [0, 1]
# the tier's pool: 23 pages against six 6-page templates
TIER = dict(prefix_cache=True, num_pages=24)
# the sentinel at its tightest: a weight probe every idle step, the
# shadow every second step
SENTINEL = dict(weight_audit_every=1, shadow_every=2)
HANDOFF_PROMPT = np.arange(3, 27, dtype=np.int32)  # three full pages

# (layout, option): engine keywords and workload
CASES = {
    ("tp2", "tier"): dict(kw=dict(TIER, kv_host_pages=64), body="churn"),
    # chains of one chunk: a row stays active across steps, which the
    # shadow needs
    ("tp2", "integrity"): dict(kw=dict(prefix_cache=True, max_chain=1,
                                       integrity=dict(mode="strict",
                                                      **SENTINEL)),
                               body="templated"),
    ("tp2", "draft"): dict(kw=dict(spec="draft", spec_k=4), body="serve"),
    ("ep2", "tier"): dict(kw=dict(TIER, kv_host_pages=64), body="churn"),
    ("ep2", "integrity"): dict(kw=dict(prefix_cache=True, max_chain=1,
                                       integrity=dict(mode="strict",
                                                      **SENTINEL)),
                               body="serve"),
    ("ep2", "draft"): dict(kw=dict(spec="draft", spec_k=4), body="serve"),
}
LAYOUTS = {"tp2": dict(tp=2), "ep2": dict(ep=2)}


def _cfg(layout):
    from paddle_tpu_torch.models.llama import (tiny_llama_config,
                                               tiny_moe_llama_config)

    make = tiny_moe_llama_config if layout == "ep2" else tiny_llama_config
    return make(num_heads=4, num_kv_heads=4)


def _spill_seed(first_bytes, lanes, itemsize=4):
    """A plan seed whose ``kv-spill-corrupt`` byte lands in the second
    half of a page's lanes: the follower's at tp=2."""
    from paddle_tpu_torch.testing.faultinject import FaultPlan

    for s in range(64):
        plan = FaultPlan(f"kv-spill-corrupt:at=1,seed={s}")
        b = plan.draw("kv-spill-corrupt", first_bytes)
        if (b // itemsize) % lanes >= lanes // 2:
            return s
    raise AssertionError("no seed in range")


# ------------------------------------------------------------ the ranks
def _option(rank, layout, case, model_fn, draft_fn, vocab):
    """One option on the sharded engine: rank 0 runs the body; every
    rank records its command outputs."""
    from paddle_tpu_torch.inference.engine import Engine

    kw = dict(W.GEOM, device="cpu", dtype=torch.float32, **LAYOUTS[layout])
    kw.update(case["kw"])
    if kw.get("spec") == "draft":
        kw["draft_model"] = draft_fn()
    eng = Engine(model_fn(), **kw)
    log = W.record_commands(eng)
    rec = dict(drafter=type(eng._spec.drafter).__name__
               if eng._spec is not None else None,
               draft_pool=hasattr(eng._spec.drafter, "k_pages")
               if eng._spec is not None else None)
    if not eng.is_leader:
        eng.run()
        rec["log"] = log
        return rec
    W.synthetic_clock(eng)
    ig = eng._integrity
    if ig is not None:
        shadow, rec["shadows"] = ig.shadow_check, []
        ig.shadow_check = lambda: rec["shadows"].append(shadow())
    reqs = W.BODIES[case["body"]](eng, vocab)
    rec.update(W.outcome(eng, reqs))
    if ig is not None:
        rec["page_sum"] = dict(ig._page_sum)
        pages = sorted(ig._page_sum)
        if pages:
            from paddle_tpu_torch.inference.integrity import page_checksums

            whole = eng.runner.gather_pages(pages)
            rec["whole_sums"] = page_checksums(
                whole, torch.arange(len(pages))).tolist()
            rec["sums_now"] = eng.runner.page_sums(pages)
        rec["quarantined"] = eng._watchdog.quarantined
    if eng.kv_tier is not None:
        t = eng.kv_tier
        rec["tier"] = (t.demotions, t.promotions, t.drops)
        eng._cache.shutdown_tier()
    if eng._spec is not None:
        rec["spec"] = eng._spec.stats()
    eng.close()
    rec["log"] = log
    return rec


def _unsharded(model_fn, draft_fn, vocab, case):
    """The same option on the port's tp=None engine (rank 0's process)."""
    from paddle_tpu_torch.inference.engine import Engine

    kw = dict(W.GEOM, device="cpu", dtype=torch.float32)
    kw.update(case["kw"])
    if kw.get("spec") == "draft":
        kw["draft_model"] = draft_fn()
    eng = W.synthetic_clock(Engine(model_fn(), **kw))
    reqs = W.BODIES[case["body"]](eng, vocab)
    out = W.outcome(eng, reqs)
    if eng._integrity is not None:
        out["page_sum"] = dict(eng._integrity._page_sum)
    if eng._spec is not None:
        out["spec"] = eng._spec.stats()
    eng._cache.shutdown_tier()
    return out


def _spill_corrupt(rank, model_fn, vocab):
    """kv-spill-corrupt at tp=2, its byte in the follower's lanes."""
    from paddle_tpu_torch.inference.engine import Engine

    cfg = _cfg("tp2")
    lanes = cfg.num_kv_heads * cfg.head_dim
    seed = _spill_seed(W.GEOM["page_size"] * lanes * 4, lanes)
    kw = dict(W.GEOM, device="cpu", dtype=torch.float32, tp=2,
              kv_host_pages=64,
              fault_plan=f"kv-spill-corrupt:at=1,seed={seed}", **TIER)
    eng = Engine(model_fn(), **kw)
    if not eng.is_leader:
        eng.run()
        return {}
    W.synthetic_clock(eng)
    reqs = W.body_churn(eng, vocab)
    rec = W.outcome(eng, reqs)
    rec["fired"] = eng._fi.fired("kv-spill-corrupt")
    rec["tier"] = (eng.kv_tier.demotions, eng.kv_tier.promotions,
                   eng.kv_tier.drops)
    eng._cache.shutdown_tier()
    eng.close()
    return rec


def _bit_flip(rank, model_fn, vocab):
    """bit-flip-weight on the second block of layer 0's o_proj: at tp=2 a
    row-parallel weight's second half is rank 1's shard."""
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.testing.faultinject import FaultPlan

    eng = Engine(model_fn(), device="cpu", tp=2,
                 integrity=dict(weight_audit_every=1), **W.GEOM)
    name = "model.layers.0.self_attn.o_proj.weight"
    names = [n for n, _ in eng.model.named_parameters()]
    i = names.index(name)
    before = eng._params[i].detach().clone()
    if eng.is_leader:
        # the next probe takes that block, and the flip fires there
        ig = eng._integrity
        ig._probe_cursor = ig._probe_targets.index((i, 1))
        eng._fi = FaultPlan("bit-flip-weight:at=1")
        W.body_serve(eng, vocab)
        rec = dict(quarantined=eng._watchdog.quarantined,
                   error=str(eng._integrity.last_error),
                   fired=eng._fi.fired("bit-flip-weight"))
        eng.close()
    else:
        eng.run()
        rec = {}
    rec["changed"] = int((eng._params[i] != before).sum())
    return rec


def _handoff(rank, layout, model_fn, vocab):
    """tp=2 (or ep=2) export, the same prompt exported at tp=None, a
    tp=None engine adopting the sharded payload and a sharded engine
    adopting the tp=None engine's: the streams and payloads."""
    from paddle_tpu_torch.inference.engine import Engine

    kw = dict(W.GEOM, device="cpu", dtype=torch.float32, prefix_cache=True)
    rec = {}

    def serve(eng):
        req = eng.add_request(HANDOFF_PROMPT, 6)
        eng.run()
        return list(map(int, req.tokens))

    a = Engine(model_fn(), **kw, **LAYOUTS[layout])
    if a.is_leader:
        rec["direct"] = serve(a)
        pay_a = a._cache.export_handoff(HANDOFF_PROMPT)
        a.close()
        u = Engine(model_fn(), **kw)
        rec["unsharded"] = serve(u)
        pay_u = u._cache.export_handoff(HANDOFF_PROMPT)
        rec["same_layout"] = (
            pay_a["tokens"] == pay_u["tokens"]
            and pay_a["nbytes"] == pay_u["nbytes"]
            and pay_a.keys() == pay_u.keys()
            and [[(x.dtype, x.shape) for x in r] for r in pay_a["pages"]]
            == [[(x.dtype, x.shape) for x in r] for r in pay_u["pages"]])
        # which buffers hold the tp=None engine's bytes (layer 1's
        # inputs went through the all-reduce)
        rec["equal_buffers"] = [all(torch.equal(ra[j], ru[j]) for ra, ru
                                    in zip(pay_a["pages"], pay_u["pages"]))
                                for j in range(len(pay_a["pages"][0]))]
        rec["n_pages"] = len(pay_a["pages"])
        v = Engine(model_fn(), **kw)
        rec["adopted_unsharded"] = v.adopt_kv_pages(pay_a)
        rec["via_unsharded"] = serve(v)
        rec["hits_unsharded"] = v._pcache.hits
        pay_v = v._cache.export_handoff(HANDOFF_PROMPT)
        # the tp=None engine holds the sharded export's bytes exactly
        rec["same_bytes"] = pay_v["digests"] == pay_a["digests"] and all(
            torch.equal(x, y) for rv, ra in zip(pay_v["pages"],
                                                pay_a["pages"])
            for x, y in zip(rv, ra))
    else:
        a.run()
    b = Engine(model_fn(), **kw, **LAYOUTS[layout])
    if b.is_leader:
        rec["adopted_sharded"] = b.adopt_kv_pages(pay_v)
        rec["round_trip"] = serve(b)
        rec["hits_sharded"] = b._pcache.hits
        rec["payload_back"] = b._cache.export_handoff(
            HANDOFF_PROMPT)["digests"] == pay_v["digests"]
        b.close()
    else:
        b.run()
    return rec


def _worker(rank, world, init_file, out_dir, dense_file, moe_file):
    from paddle_tpu_torch.convert import llama_from_numpy

    W.init_world(rank, world, init_file)
    arrays = {"tp2": dict(np.load(dense_file)), "ep2": dict(np.load(moe_file))}
    res = {}
    for (layout, option), case in CASES.items():
        cfg = _cfg(layout)

        def model_fn(cfg=cfg, a=arrays[layout]):
            return llama_from_numpy(cfg, a, device="cpu")

        def draft_fn(a=arrays["tp2"]):
            # the dense target whole: its drafts are the target's own
            return llama_from_numpy(_cfg("tp2"), a, device="cpu")

        res[(layout, option)] = _option(rank, layout, case, model_fn,
                                        draft_fn, cfg.vocab_size)
        if rank == 0:
            res[(layout, option, "unsharded")] = _unsharded(
                model_fn, draft_fn, cfg.vocab_size, case)
    for layout in LAYOUTS:
        cfg = _cfg(layout)
        res[(layout, "handoff")] = _handoff(
            rank, layout, lambda cfg=cfg, a=arrays[layout]:
            llama_from_numpy(cfg, a, device="cpu"), cfg.vocab_size)

    def dense():
        return llama_from_numpy(_cfg("tp2"), arrays["tp2"], device="cpu")

    res["spill_corrupt"] = _spill_corrupt(rank, dense, 128)
    res["bit_flip"] = _bit_flip(rank, dense, 128)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


# ------------------------------------------------------------- fixtures
def _jax_llama(moe=False):
    import paddle_tpu as paddle
    from paddle_tpu.models import llama as jllama

    paddle.seed(0)
    make = jllama.tiny_moe_llama_config if moe else jllama.tiny_llama_config
    jm = jllama.LlamaForCausalLM(make(num_heads=4, num_kv_heads=4))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def jax_models():
    """The dense and MoE JAX models; the MoE side's grouped matmul runs
    ``grouped_matmul_ref``, as ``test_torch_ep_serving.py`` patches it."""
    import paddle_tpu.ops.pallas.grouped_matmul  # noqa: F401

    mod = sys.modules["paddle_tpu.ops.pallas.grouped_matmul"]
    kept = mod.grouped_matmul
    mod.grouped_matmul = mod.grouped_matmul_ref
    try:
        yield {"tp2": _jax_llama(), "ep2": _jax_llama(moe=True)}
    finally:
        mod.grouped_matmul = kept


@pytest.fixture(scope="module")
def port(jax_models, tmp_path_factory):
    from paddle_tpu.jit import param_arrays

    tmp = tmp_path_factory.mktemp("tp_options")
    files = []
    for layout in ("tp2", "ep2"):
        f = tmp / f"{layout}.npz"
        np.savez(f, **{k: np.asarray(v) for k, v in
                       param_arrays(jax_models[layout]).items()})
        files.append(str(f))
    return W.run_world(_worker, WORLD, tmp, *files)


@pytest.fixture(scope="module")
def jax_base(jax_models):
    """The JAX engine at tp=None with every option off, per workload."""
    out = {}
    for layout, jm in jax_models.items():
        for body, kw in (("serve", {}), ("templated",
                                         dict(prefix_cache=True)),
                         ("churn", dict(TIER))):
            if layout == "ep2" and body == "templated":
                continue
            out[(layout, body)] = W.jax_serve(jm, dict(kw=kw, body=body))
    return out


def _pair(port, key):
    return port[0][key], port[1][key]


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("layout,option", list(CASES),
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_streams_equal_jax_unsharded(port, jax_base, layout, option):
    """Rank 0's streams with the option on equal the JAX engine's at
    tp=None (and the port's tp=None engine's with the option on); the
    follower ran every command rank 0 ran, to the same bits."""
    lead, follower = _pair(port, (layout, option))
    case = CASES[(layout, option)]
    want = jax_base[(layout, case["body"])]
    assert lead["tokens"] == want["tokens"]
    assert lead["reasons"] == want["reasons"] == [None] * len(want["tokens"])
    assert lead["tokens"] == port[0][(layout, option, "unsharded")]["tokens"]
    assert len(lead["log"]) > 0
    W.same_log(follower["log"], lead["log"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tier_demotes_and_promotes(port, jax_base, layout):
    """The churn overflows the pool: pages demote to rank 0's slab (every
    rank's lanes) and promote back; the tier-on streams equal the tier-off
    ones (the JAX engine's with the prefix cache alone)."""
    lead, _ = _pair(port, (layout, "tier"))
    demoted, promoted, _ = lead["tier"]
    assert demoted > 0 and promoted > 0
    assert lead["hits"] > 0
    assert lead["tokens"] == jax_base[(layout, "churn")]["tokens"]


def test_spill_corrupt_in_follower_lanes_is_contained(port, jax_base):
    lead = port[0]["spill_corrupt"]
    assert lead["fired"] == 1
    assert lead["tier"][2] >= 1  # the corrupt block was dropped
    assert lead["tokens"] == jax_base[("tp2", "churn")]["tokens"]


def test_page_sums_equal_unsharded_bitwise(port):
    """The sentinel's page sums at tp=2 (each rank sums its lanes, one
    all-reduce) are, bit for bit, the tp=None checksum of the same pages
    whole (gathered from both ranks), at registration and after the run;
    the tp=None engine checksummed the same pages. (Its page bytes are
    not the tp=2 engine's: the all-reduce rounds layer 1's input in
    another order.)"""
    lead, _ = _pair(port, ("tp2", "integrity"))
    plain = port[0][("tp2", "integrity", "unsharded")]
    assert lead["page_sum"] and set(lead["page_sum"]) == set(
        plain["page_sum"])
    pages = sorted(lead["page_sum"])
    assert lead["sums_now"] == lead["whole_sums"] == [
        lead["page_sum"][p] for p in pages]


def test_strict_shadow_runs_sharded(port):
    """The shadow recompute ran on both ranks (a command) and agreed."""
    for layout in LAYOUTS:
        lead, _ = _pair(port, (layout, "integrity"))
        ran = [ok for ok in lead["shadows"] if ok is not None]
        assert ran and all(ran), (layout, lead["shadows"])
        assert not lead["quarantined"]


def test_bit_flip_in_follower_shard_quarantines(port):
    lead, follower = _pair(port, "bit_flip")
    assert lead["fired"] == 1 and lead["quarantined"]
    assert "rank 1" in lead["error"] and "weight audit" in lead["error"]
    assert follower["changed"] == 1 and lead["changed"] == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handoff_payload_and_round_trip(port, layout):
    """The sharded export is the tp=None export byte for byte; the
    payload adopted at tp=None and handed back to a sharded engine gives
    the stream of no handoff, from spliced pages."""
    rec = port[0][(layout, "handoff")]
    assert rec["n_pages"] == len(HANDOFF_PROMPT) // W.GEOM["page_size"]
    assert rec["same_layout"] and rec["same_bytes"]
    # [k0, k1, v0, v1]: at tp=2 layer 1's K/V went through the all-reduce
    # and round in another order; layer 0's are the tp=None engine's
    assert rec["equal_buffers"] == ([True, False, True, False]
                                    if layout == "tp2" else [True] * 4)
    assert rec["direct"] == rec["unsharded"] == rec["via_unsharded"] \
        == rec["round_trip"]
    assert rec["adopted_unsharded"] == rec["adopted_sharded"] == 3
    assert rec["hits_unsharded"] == rec["hits_sharded"] == 1
    assert rec["payload_back"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_draft_on_rank0_only(port, layout):
    """Rank 0 drafts (the target's own weights: every draft of a greedy
    row lands); the follower builds no drafter and no draft pool, and
    the acceptance equals the tp=None engine's."""
    lead, follower = _pair(port, (layout, "draft"))
    assert lead["drafter"] == "DraftModelDrafter" and lead["draft_pool"]
    assert follower["drafter"] == "FollowerDrafter"
    assert not follower["draft_pool"]
    plain = port[0][(layout, "draft", "unsharded")]["spec"]
    for key in ("verify_steps", "tokens_landed", "accept_rate"):
        assert lead["spec"][key] == plain[key], key
    if layout == "tp2":
        assert lead["spec"]["accept_rate"] == 1.0


def test_integrity_equals_jax_tp2(port, jax_models):
    """The sentinel's scenario against the JAX engine sharded the same
    way (tp=2 on the 8-device CPU mesh, its sentinel on)."""
    case = dict(CASES[("tp2", "integrity")])
    want = W.jax_serve(jax_models["tp2"], case, tp=2)
    assert port[0][("tp2", "integrity")]["tokens"] == want["tokens"]


def test_weight_only_quantized_refused_at_tp2():
    """The one refusal left: a weight-only quantized model at tp/ep > 1
    raises TypeError naming why (before anything communicates)."""
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    model = LlamaForCausalLM(_cfg("tp2"), device="cpu")
    quantize_for_decode(model)
    for kw in (dict(tp=2), dict(ep=2)):
        with pytest.raises(TypeError, match="weight-only quantized.*"
                                            "RetriesExhausted"):
            Engine(model, device="cpu", **W.GEOM, **kw)


def test_reference_tp2_quantized_fails_every_request(jax_models):
    """The divergence, recorded: the reference's tp=2 engine over a
    ``quantize_for_decode`` model replicates the int8 weight buffers
    whole, its steps fault, and every request ends RetriesExhausted
    with no tokens."""
    import jax.numpy as jnp

    from paddle_tpu.inference.engine import Engine as JaxEngine
    from paddle_tpu.nn.quant import quantize_for_decode as jquant

    jm = _jax_llama()
    jquant(jm)
    eng = JaxEngine(jm, tp=2, dtype=jnp.float32, metrics=False, **W.GEOM)
    reqs = [eng.add_request(np.arange(1, 9, dtype=np.int32), 4)
            for _ in range(2)]
    eng.run()
    assert [r.failure_reason for r in reqs] == ["retries_exhausted"] * 2
    assert all(not r.tokens for r in reqs)
    assert "max_retries" in str(reqs[0].failure)
