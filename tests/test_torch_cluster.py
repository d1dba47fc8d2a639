"""The port's cluster layer (``paddle_tpu_torch.serving.cluster``: role
pools, the KV handoff between replicas, cache-aware placement, the
autoscaler) against paddle_tpu's, after ``tests/test_cluster_serving.py``.

* Placement and autoscale units on stub replicas (no engines): on the same
  readiness payloads and submissions the port's router and coordinator
  make the JAX package's choices (``parse_pools``, the role order,
  ``outbound``'s one-token cap and its skip, ``_pick`` by role with
  borrowing, ``choose`` by overlap then load, mixed-version payloads,
  reassign / spawn / drain and their metrics).
* Pooled serving on tiny LLaMA (f32, the JAX model's weights carried
  across, ``page_size=8``, ``chunk_size=4``): the handoff round trip, a
  corrupt handoff, a stalled one, a prefill replica killed mid-handoff and
  a mixed-version fleet each give the direct port engine's stream, which
  equals the JAX engine's. These five are marked slow, as the reference
  marks them.

Every blocking wait carries its own timeout.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.serving as jsv
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.jit import param_arrays
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import tiny_llama_config as jax_tiny
from paddle_tpu.observability import metric_total as jax_metric
from paddle_tpu.serving.router import RouterTicket as JaxTicket

import paddle_tpu_torch.serving as tsv
from paddle_tpu_torch.convert import llama_from_numpy
from paddle_tpu_torch.inference.engine import Engine
from paddle_tpu_torch.models.llama import tiny_llama_config
from paddle_tpu_torch.observability import metric_total
from paddle_tpu_torch.serving.router import RouterTicket
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
PROMPT = list(range(1, 21))
GEOM = dict(page_size=8, chunk_size=4)
WAIT = 180  # seconds any single blocking wait may take


# ------------------------------------------------------------ stub fleet
def _stub_cls(base):
    class StubReplica(base):
        """The replica surface with health and load as plain attributes,
        no engine anywhere (the reference test's stub, on ``base``)."""

        def __init__(self, name, index, load=0, payload=None):
            super().__init__(name, index)
            self._alive = True
            self._load = int(load)
            self.payload = dict(payload or {})
            self.stopped = False

        def alive(self):
            return self._alive

        def ready(self):
            out = {"ready": self._alive, "queue_depth": 0}
            out.update(self.payload)
            return out

        @property
        def inflight(self):
            return self._load

        def start(self):
            self._alive = True

        def stop(self):
            self.stopped = True
            self._alive = False

        def kill(self):
            self._alive = False

    return StubReplica


SIDES = {"jax": (jsv, _stub_cls(jsv.Replica), JaxTicket, jax_metric),
         "port": (tsv, _stub_cls(tsv.Replica), RouterTicket, metric_total)}


def _both(scenario):
    """Run ``scenario(sv, Stub, Ticket, metric)`` on the JAX package's
    router and on the port's; returns (jax result, port result)."""
    return tuple(scenario(*SIDES[side]) for side in ("jax", "port"))


def _stub_router(sv, Stub, n=3, pools=None, **kw):
    reps = [Stub(f"s{i}", i) for i in range(n)]
    router = sv.Router(reps, pools=pools or {"prefill": 1,
                                             "decode": n - 1}, **kw)
    return router, reps  # never started: no monitor thread to clean up


def _idx(reps, rep):
    return None if rep is None else reps.index(rep)


# ------------------------------------------------------- placement units
def test_parse_pools_matches_reference():
    for spec in ("prefill=1,decode=2", "decode=4", " prefill=3 ,",
                 "", "prefill=x", "draw=2", "prefill"):
        got = []
        for parse in (jsv.parse_pools, tsv.parse_pools):
            try:
                got.append(parse(spec))
            except ValueError:
                got.append(ValueError)
        assert got[0] == got[1], spec
    assert tsv.parse_pools("prefill=1,decode=2") == {"prefill": 1,
                                                     "decode": 2}


def test_roles_assigned_in_order_with_decode_overflow():
    def scenario(sv, Stub, *_):
        router, reps = _stub_router(sv, Stub, 4,
                                    pools={"prefill": 1, "decode": 2})
        cl = router.cluster
        return [cl.role_of(r) for r in reps], cl.pool_sizes()

    want, got = _both(scenario)
    assert got == want
    assert got[0] == ["prefill", "decode", "decode", "decode"]
    assert got[1] == {"prefill": 1, "decode": 3}


def test_outbound_caps_prefill_leg_to_one_token():
    def scenario(sv, Stub, Ticket, _):
        router, reps = _stub_router(sv, Stub)
        cl = router.cluster
        cl.observe(reps[0], {"page_size": 8})
        spec = sv.StreamSpec(PROMPT, 16)
        ticket = Ticket(spec)
        sub, role = cl.outbound(ticket, spec)
        return (role, ticket.phase, sub.max_new_tokens, sub.prompt,
                ticket.spec.max_new_tokens)

    want, got = _both(scenario)
    assert got == want == ("prefill", "prefill", 1, PROMPT, 16)


def test_outbound_skips_disaggregation_when_not_worth_it():
    def scenario(sv, Stub, Ticket, _):
        router, reps = _stub_router(sv, Stub)
        cl = router.cluster
        cl.observe(reps[0], {"page_size": 8})
        out = []
        # budget 1: the prefill leg IS the request
        t1 = Ticket(sv.StreamSpec(PROMPT, 1))
        sub, role = cl.outbound(t1, t1.spec)
        out.append((role, sub.max_new_tokens))
        # a prompt under one page: nothing cacheable to ship
        t2 = Ticket(sv.StreamSpec([1, 2, 3], 16))
        sub, role = cl.outbound(t2, t2.spec)
        out.append((role, sub.max_new_tokens))
        # a resumed placement (continuation or migration): decode pool
        t3 = Ticket(sv.StreamSpec(PROMPT, 16))
        sub, role = cl.outbound(t3, sv.StreamSpec(PROMPT, 16,
                                                  resume_tokens=[5]))
        out.append((role, t3.phase))
        return out

    want, got = _both(scenario)
    assert got == want == [("decode", 1), ("decode", 16),
                           ("decode", "decode")]


def test_pick_filters_by_role_and_borrows_when_pool_empty():
    def scenario(sv, Stub, *_):
        router, reps = _stub_router(sv, Stub)
        out = [_idx(reps, router._pick(role="prefill")),
               _idx(reps, router._pick(role="decode"))]
        # a dead pool borrows cross-role: availability beats purity
        reps[0].kill()
        out.append(_idx(reps, router._pick(role="prefill")))
        reps[1]._load = 2
        out.append(_idx(reps, router._pick(role="prefill")))
        for r in reps:
            r.kill()
        out.append(_idx(reps, router._pick(role="decode")))
        return out

    want, got = _both(scenario)
    assert got == want
    assert got[0] == 0 and got[1] in (1, 2) and got[2] in (1, 2)
    assert got[3] == 2 and got[4] is None


def test_cache_aware_placement_beats_least_loaded():
    def scenario(sv, Stub, *_):
        router, reps = _stub_router(sv, Stub)
        cl = router.cluster
        cl.observe(reps[1], {"page_size": 8})
        keys = cl.prompt_keys(PROMPT)
        # replica 2 holds the prompt's chain but carries MORE load:
        # overlap depth outranks load
        reps[1]._load, reps[2]._load = 0, 1
        cl.observe(reps[2], {"kv_chains": keys})
        spec = sv.StreamSpec(PROMPT, 16)
        out = [keys, _idx(reps, cl.choose([reps[1], reps[2]], spec))]
        # no overlap anywhere: least-loaded
        other = sv.StreamSpec(list(range(40, 60)), 16)
        out.append(_idx(reps, cl.choose([reps[1], reps[2]], other)))
        # a partial overlap loses to a deeper one
        cl.observe(reps[1], {"kv_chains": keys[:1]})
        out.append(_idx(reps, cl.choose([reps[1], reps[2]], spec)))
        # the router's pick with the spec goes through the scoring
        out.append(_idx(reps, router._pick(role="decode", spec=spec)))
        return out

    want, got = _both(scenario)
    # the chain keys themselves are the reference's (same blake2b chain)
    assert got == want
    assert len(got[0]) == len(PROMPT) // 8
    assert got[1:] == [2, 1, 2, 2]


def test_mixed_version_readiness_routes_availability_only():
    """A replica whose readiness payload predates ``kv_chains`` /
    ``page_size`` / ``eos_id`` still routes, by load; a replica that
    reports them wins for its prefix."""
    def scenario(sv, Stub, *_):
        router, reps = _stub_router(sv, Stub)
        cl = router.cluster
        cl.observe(reps[1], {"ready": True, "queue_depth": 0})  # old
        cl.observe(reps[2], {"ready": True})                    # old
        out = [cl._page_size, cl.prompt_keys(PROMPT)]
        reps[1]._load, reps[2]._load = 2, 1
        spec = sv.StreamSpec(PROMPT, 16)
        out.append(_idx(reps, cl.choose([reps[1], reps[2]], spec)))
        cl.observe(reps[1], {"page_size": 8})
        cl.observe(reps[1], {"kv_chains": cl.prompt_keys(PROMPT)})
        out.append(_idx(reps, cl.choose([reps[1], reps[2]], spec)))
        return out

    want, got = _both(scenario)
    assert got == want == [None, [], 2, 1]


# ---------------------------------------------------- autoscale (units)
def test_reassigns_idle_donor_to_starved_pool():
    def scenario(sv, Stub, _, metric):
        router, reps = _stub_router(sv, Stub, 3, heartbeat_s=10.0)
        cl = router.cluster
        r0 = metric("paddle_tpu_cluster_rebalances_total")
        reps[0].payload["queue_depth"] = 20       # prefill starved
        cl.observe(reps[1], {"inflight": 0})      # idle decode donors
        cl.observe(reps[2], {"inflight": 0})
        cl.autoscale_tick()
        out = [cl.pool_sizes(), [cl.role_of(r) for r in reps],
               metric("paddle_tpu_cluster_rebalances_total") - r0]
        # decode is AT min_per_role now: a second tick must not strip it
        cl.autoscale_tick()
        out.append(cl.pool_sizes())
        return out

    want, got = _both(scenario)
    assert got == want
    assert got[0] == {"prefill": 2, "decode": 1} and got[2] == 1
    assert got[3]["decode"] == 1


def test_spawns_through_factory_when_both_pools_backlogged():
    def scenario(sv, Stub, _, metric):
        spawned = []

        def factory():
            rep = Stub(f"x{len(spawned)}", 90 + len(spawned))
            spawned.append(rep)
            return rep

        reps = [Stub(f"s{i}", i, payload={"queue_depth": 20})
                for i in range(2)]
        router = sv.Router(reps, pools={"prefill": 1, "decode": 1},
                           replica_factory=factory,
                           autoscale={"queue_high": 4, "max_replicas": 3})
        cl = router.cluster
        r0 = metric("paddle_tpu_cluster_rebalances_total")
        cl.autoscale_tick()
        out = [len(spawned), len(router.replicas), cl.pool_sizes(),
               cl.role_of(spawned[0]),
               metric("paddle_tpu_cluster_rebalances_total") - r0]
        cl.autoscale_tick()  # at max_replicas: no further growth
        out.append(len(spawned))
        return out

    want, got = _both(scenario)
    assert got == want
    assert got[:2] == [1, 3] and sum(got[2].values()) == 3
    assert got[4] == 1 and got[5] == 1


def test_drains_surplus_idle_replica_and_supervisor_skips_it():
    def scenario(sv, Stub, _, metric):
        router, reps = _stub_router(sv, Stub, 3, heartbeat_s=10.0)
        cl = router.cluster
        cl.autoscale_tick()
        out = [[r.stopped for r in reps]]  # no idle clock yet
        for r in reps[1:]:
            cl.observe(r, {"inflight": 0})
        cl.idle_grace_s = 0.0
        r0 = metric("paddle_tpu_cluster_rebalances_total")
        cl.autoscale_tick()
        drained = [i for i, r in enumerate(reps) if r.stopped]
        out += [cl.pool_sizes(), drained,
                metric("paddle_tpu_cluster_rebalances_total") - r0,
                _idx(reps, router._pick(role="decode")),
                cl.is_drained(drained[0]), cl.role_of(reps[drained[0]])]
        cl.autoscale_tick()  # min_per_role floors the shrink
        out.append(cl.pool_sizes())
        return out

    want, got = _both(scenario)
    assert got == want
    assert not any(got[0]) and got[1] == {"prefill": 1, "decode": 1}
    assert len(got[2]) == 1 and got[3] == 1
    assert got[4] != got[2][0] and got[5] is True and got[6] is None
    assert got[7] == {"prefill": 1, "decode": 1}


def test_corrupt_payload_flips_the_reference_byte_on_a_copy():
    """``kv-handoff-corrupt``'s damage: the same plan picks the same page
    and byte in both packages, and the flip lands on a copy (the rows the
    export handed over stay as they were)."""
    import torch

    from paddle_tpu.testing.faultinject import FaultPlan as JaxPlan
    from paddle_tpu_torch.serving.cluster import ClusterCoordinator
    from paddle_tpu_torch.testing.faultinject import FaultPlan

    from paddle_tpu.serving.cluster import ClusterCoordinator as JaxCoord

    rng = np.random.default_rng(3)
    rows = [[rng.standard_normal((8, 2, 4)).astype(np.float32)
             for _ in range(4)] for _ in range(3)]
    jpay = {"pages": [list(r) for r in rows]}
    host = torch.from_numpy(np.stack([r[0] for r in rows]))
    tpay = {"pages": [[host[j]] + [torch.from_numpy(a) for a in r[1:]]
                      for j, r in enumerate(rows)]}
    JaxCoord._corrupt_payload(jpay, JaxPlan("kv-handoff-corrupt", seed=5))
    ClusterCoordinator._corrupt_payload(
        tpay, FaultPlan("kv-handoff-corrupt", seed=5))
    for j in range(3):
        for i in range(4):
            assert np.asarray(tpay["pages"][j][i]).tobytes() == \
                jpay["pages"][j][i].tobytes(), (j, i)
    # exactly one byte differs from the export, and not in its buffers
    flipped = [j for j in range(3)
               if np.asarray(tpay["pages"][j][0]).tobytes()
               != rows[j][0].tobytes()]
    assert len(flipped) == 1
    assert torch.equal(host, torch.from_numpy(np.stack([r[0]
                                                        for r in rows])))


# ------------------------------------------------- pooled serving (slow)
@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = llama_from_numpy(tiny_llama_config(),
                          {k: np.asarray(v)
                           for k, v in param_arrays(jm).items()},
                          device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def reference(models):
    """The unpooled greedy stream of PROMPT: the direct port engine's,
    which must equal the JAX engine's."""
    out = []
    for eng in (JaxEngine(models[0], max_slots=2, num_pages=64,
                          dtype=jnp.float32, **GEOM),
                Engine(models[1], device="cpu", max_slots=2, num_pages=64,
                       **GEOM)):
        req = eng.add_request(np.asarray(PROMPT, np.int32), 16)
        eng.run()
        assert req.done and not req.failed
        out.append(list(req.tokens))
    assert out[0] == out[1]
    return out[1]


def _factory(models):
    def factory():
        return tsv.ServingFrontend(Engine(
            models[1], device="cpu", max_slots=2, num_pages=64,
            prefix_cache=True, **GEOM))
    return factory


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _pooled_router(models, n=3, **kw):
    reps = [tsv.InProcReplica(_factory(models), name=f"c{i}", index=i)
            for i in range(n)]
    kw.setdefault("heartbeat_s", 0.05)
    kw.setdefault("stall_s", None)
    kw.setdefault("pools", {"prefill": 1, "decode": n - 1})
    return tsv.Router(reps, **kw), reps


def _counts():
    return {k: metric_total(f"paddle_tpu_{k}_total")
            for k in ("cluster_handoffs", "cluster_handoff_bytes",
                      "cluster_fallbacks", "request_failures")}


def _delta(c0):
    return {k: v - c0[k] for k, v in _counts().items()}


@pytest.mark.slow
def test_handoff_round_trip_is_bit_identical(models, reference):
    """Prefill on one pool, decode on the other, the KV shipped once and
    digest-verified: the client sees the single-engine stream exactly, and
    a second stream on the same prefix rides the warmed decode replica."""
    router, reps = _pooled_router(models)
    router.start()
    try:
        assert _wait(lambda: router.cluster._page_size is not None)
        c0 = _counts()
        chunks = []
        t = router.submit(PROMPT, 16, on_chunk=lambda c: chunks.append(c))
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None and t.phase == "decode"
        flat = [tok for c in chunks if c for tok in c]
        assert flat == reference and chunks[-1] is None
        d = _delta(c0)
        assert d["cluster_handoffs"] == 1 and d["cluster_handoff_bytes"] > 0
        assert d["cluster_fallbacks"] == 0 and d["request_failures"] == 0
        t2 = router.submit(PROMPT, 16)
        assert t2.result(timeout=WAIT) == reference
        assert t2.replica in [r.name for r in reps[1:]]
    finally:
        router.shutdown()


@pytest.mark.slow
def test_corrupt_handoff_falls_back_bit_identically(models, reference):
    """``kv-handoff-corrupt``: one byte flipped in transit. The decode
    side's digest check voids or truncates the adoption, the rest is
    recomputed: the same tokens, zero failures, the degradation counted."""
    router, _ = _pooled_router(models,
                               fault_plan="kv-handoff-corrupt:every=1")
    router.start()
    try:
        assert _wait(lambda: router.cluster._page_size is not None)
        c0 = _counts()
        t = router.submit(PROMPT, 16)
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None
        d = _delta(c0)
        assert d["cluster_handoffs"] + d["cluster_fallbacks"] == 1
        assert d["request_failures"] == 0
    finally:
        router.shutdown()


@pytest.mark.slow
def test_stalled_handoff_degrades_without_deadlock(models, reference):
    """``kv-handoff-stall`` past ``handoff_budget_s``: the shipment is
    abandoned, the decode leg recomputes, nothing blocks."""
    router, _ = _pooled_router(
        models, fault_plan="kv-handoff-stall:every=1,delay_ms=300",
        handoff_budget_s=0.05)
    router.start()
    try:
        assert _wait(lambda: router.cluster._page_size is not None)
        c0 = _counts()
        t = router.submit(PROMPT, 16)
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None
        d = _delta(c0)
        assert d["cluster_fallbacks"] == 1 and d["cluster_handoffs"] == 0
    finally:
        router.shutdown()


@pytest.mark.slow
def test_prefill_killed_mid_handoff_recomputes(models, reference):
    """The prefill replica killed while its handoff is held open by the
    stall point: the export fails against the dead replica, the decode
    replica recomputes from the one emitted token, the stream is the
    reference's with zero failures."""
    router, reps = _pooled_router(
        models, fault_plan="kv-handoff-stall:every=1,delay_ms=500",
        handoff_budget_s=30.0, restart_backoff_s=0.05)
    router.start()
    try:
        assert _wait(lambda: router.cluster._page_size is not None)
        c0 = _counts()
        t = router.submit(PROMPT, 16)
        assert _wait(lambda: t.phase == "handoff"), t.phase
        victim = next(r for r in reps
                      if router.cluster.role_of(r) == "prefill")
        victim.kill()
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None
        d = _delta(c0)
        assert d["cluster_fallbacks"] == 1 and d["request_failures"] == 0
    finally:
        router.shutdown()


@pytest.mark.slow
def test_mixed_version_fleet_still_serves(models, reference):
    """The decode replica predates the handoff surface (no ``kv_chains``
    in its readiness, import a no-op): routing is by availability, the
    handoff degrades to recompute, the stream is the reference's."""
    class OldReplica(tsv.InProcReplica):
        def ready(self):
            out = super().ready()
            for k in ("kv_chains", "page_size", "eos_id"):
                out.pop(k, None)
            return out

        def export_kv(self, tokens):
            return None

        def import_kv(self, payload):
            return 0

    reps = [tsv.InProcReplica(_factory(models), name="new0", index=0),
            OldReplica(_factory(models), name="old1", index=1)]
    router = tsv.Router(reps, heartbeat_s=0.05, stall_s=None,
                        pools={"prefill": 1, "decode": 1})
    router.start()
    try:
        c0 = _counts()
        t = router.submit(PROMPT, 16)
        assert t.result(timeout=WAIT) == reference
        assert t.failure_reason is None and t.replica == "old1"
        d = _delta(c0)
        assert d["cluster_fallbacks"] == 1 and d["request_failures"] == 0
    finally:
        router.shutdown()
