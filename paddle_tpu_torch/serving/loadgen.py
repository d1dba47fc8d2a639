"""Load generation that drives a serving front end or a router, and the
serving benches, after ``paddle_tpu/serving/loadgen.py``.

* **Open loop**: Poisson arrivals at a target QPS, submitted on wall
  deadlines regardless of completions (the discipline that exposes
  queueing collapse).
* **Closed loop**: fixed concurrency, the next request on a completion
  (steady-state throughput at a given parallelism).

Latency is measured host-side per ticket (submit to first chunk TTFT,
decode-tail TPOT): exact per request rather than bucketed.

The benches, each ``(cfg, on_gpu)`` with a ``GPTConfig`` (the reference
takes ``on_tpu``), build the port's ``GPTForCausalLM`` from seed 0 (bf16
on the card; f32 on the CPU, where ``on_gpu`` is False) and return the
reference's keys:

* :func:`bench_slo_serving`: the multi-step speedup on a host-bound decode
  geometry, an open-loop SLO run (p99 TTFT and TPOT at a target QPS) and
  tenant fairness (the interactive tenant's p99 TTFT under a batch flood
  against alone).
* :func:`bench_trace_serving`: the span recorder's cost, median step time
  tracing on against off in interleaved pairs.
* :func:`bench_failover_serving`: open-loop load over two in-process
  replicas behind a ``Router`` with one replica killed mid-window: zero
  failures, and the p99 TTFT of the streams not migrated against a run
  with no kill.
* :func:`bench_cluster_serving`: shared-prefix tenants over a
  prefill/decode cluster with the KV handoff: the fleet's prefix hit rate
  against one engine holding every prefix, p99 TTFT against the unpooled
  fleet, zero failures, handoffs and fallbacks.

Each engine is warmed before its measured window (:func:`_precompile`
captures every decode graph bucket and runs every prefill bucket), so no
window pays a first capture or a first kernel load.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .frontend import ServingFrontend

__all__ = ["run_open_loop", "run_closed_loop", "bench_slo_serving",
           "bench_failover_serving", "bench_trace_serving",
           "bench_cluster_serving"]


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), q))


def _lat_stats(tickets) -> Dict[str, float]:
    ttft = [t.ttft_s for t in tickets if t.ttft_s is not None]
    tpot = [t.tpot_s for t in tickets if t.tpot_s is not None]
    toks = sum(len(t.tokens) for t in tickets)
    return {
        "requests": len(tickets),
        "completed": sum(1 for t in tickets
                         if t.done and not t.failure_reason),
        "tokens": toks,
        "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
        "ttft_p99_ms": 1e3 * _percentile(ttft, 99),
        "tpot_p50_ms": 1e3 * _percentile(tpot, 50),
        "tpot_p99_ms": 1e3 * _percentile(tpot, 99),
    }


def _mk_prompt(rng, vocab: int, lo: int, hi: int):
    return rng.integers(0, vocab, (int(rng.integers(lo, hi)),))


def run_open_loop(frontend: ServingFrontend, qps: float, n_requests: int,
                  vocab: int, prompt_range=(16, 48), budget: int = 8,
                  tenant: Optional[str] = None, temperature: float = 0.0,
                  seed: int = 0, timeout_s: float = 300.0) -> Dict:
    """Poisson arrivals at ``qps``; submission times are wall-clock
    deadlines (open loop — no self-throttling). Returns latency stats
    over the completed run plus the QPS actually sustained."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=n_requests)
    tickets = []
    t0 = time.perf_counter()
    next_at = t0
    for i in range(n_requests):
        next_at += gaps[i]
        delay = next_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tickets.append(frontend.submit(
            _mk_prompt(rng, vocab, *prompt_range), budget,
            temperature=temperature, seed=seed + i, tenant=tenant))
    for t in tickets:
        t.result(timeout=timeout_s)
    wall = time.perf_counter() - t0
    out = _lat_stats(tickets)
    out["offered_qps"] = qps
    out["sustained_qps"] = n_requests / wall if wall else 0.0
    out["wall_s"] = wall
    return out


def run_closed_loop(frontend: ServingFrontend, concurrency: int,
                    n_requests: int, vocab: int, prompt_range=(16, 48),
                    budget: int = 8, tenant: Optional[str] = None,
                    seed: int = 0, timeout_s: float = 300.0) -> Dict:
    """Fixed-concurrency closed loop: ``concurrency`` streams in
    flight, each completion immediately replaced."""
    rng = np.random.default_rng(seed)
    tickets = []
    live: List = []
    submitted = 0
    t0 = time.perf_counter()
    while submitted < n_requests or live:
        while submitted < n_requests and len(live) < concurrency:
            t = frontend.submit(_mk_prompt(rng, vocab, *prompt_range),
                                budget, seed=seed + submitted,
                                tenant=tenant)
            tickets.append(t)
            live.append(t)
            submitted += 1
        live[0].result(timeout=timeout_s)
        live = [t for t in live if not t.done]
    wall = time.perf_counter() - t0
    out = _lat_stats(tickets)
    out["concurrency"] = concurrency
    out["tokens_per_sec"] = out["tokens"] / wall if wall else 0.0
    out["wall_s"] = wall
    return out


# ------------------------------------------------------------------ bench
def _precompile(eng, seq_buckets, sampling: bool = False):
    """Warm the engine's whole reachable program lattice up front: every
    (active-slot pow2 bucket, chain depth pow2) decode program (the depths
    the boundary-cost probes can pick mid-serve included: on the card each
    bucket's token step is captured as a CUDA graph here) and every
    prompt-length prefill bucket the workload will hit. The dummy runs
    write only to the trash page (zero tables and lengths), so the pool's
    state is untouched. A measured window then pays no first capture and
    no first kernel load."""
    import torch

    from ..inference.engine import _pow2ceil

    dev = eng.device
    nb_full = _pow2ceil(eng.max_slots)
    nbs = sorted({1 << i for i in range(nb_full.bit_length())
                  if (1 << i) <= nb_full})
    ks = sorted({1 << i for i in range(eng.max_chain.bit_length())
                 if (1 << i) <= eng.max_chain})

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    for nb in nbs:
        for k in ks:
            _, _, _, bad = eng.runner.get_decode(nb, k, sampling)(
                zeros((nb, eng.max_pages_per_seq), torch.int32),
                zeros((nb,), torch.int32), zeros((nb,), torch.int64),
                zeros((nb,), torch.float32), zeros((nb, 2), torch.int64))
            bad.cpu()
    for seq in seq_buckets:
        prefill = eng.runner.get_prefill((nb_full, seq), sampling, False)
        _, _, bad = prefill(
            zeros((nb_full, seq), torch.int64),
            torch.ones((nb_full,), dtype=torch.int32, device=dev),
            zeros((nb_full, eng.max_pages_per_seq), torch.int32),
            zeros((nb_full,), torch.int32), zeros((nb_full,), torch.float32),
            zeros((nb_full, 2), torch.int64))
        bad.cpu()


def _decode_rate(eng, prompts, budget: int) -> float:
    """Steady-state pure-decode tokens/s: admit everything, then time the
    decode phase alone (the multi-step fast path's regime)."""
    reqs = [eng.add_request(p, budget) for p in prompts]
    eng._admit()  # prefill outside the timed window
    done0 = sum(len(r.tokens) for r in reqs)
    t0 = time.perf_counter()
    while eng.step():
        pass
    dt = time.perf_counter() - t0
    return (sum(len(r.tokens) for r in reqs) - done0) / dt


def _bench_model(cfg, on_gpu: bool):
    """The bench's GPT from seed 0: bf16 on the card, f32 on the CPU."""
    import torch

    from ..convert import init_gpt

    if on_gpu:
        model = init_gpt(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    else:
        model = init_gpt(cfg, seed=0, device="cpu", dtype=torch.float32)
    model.eval()
    return model


def bench_slo_serving(cfg, on_gpu: bool) -> Dict:
    """The multi-step, open-loop SLO and fairness block; see the module
    docstring. The gates are the reference's: multi-step speedup >= 1.2x,
    p99 TTFT/TPOT under their budgets at >= 80% of the target QPS, the
    interactive tenant's flooded p99 TTFT under 2x its unloaded one."""
    from ..inference.engine import Engine
    from ..observability import histogram_summary

    model = _bench_model(cfg, on_gpu)
    vocab = cfg.vocab_size
    out: Dict = {}

    # -- multi-step: a host-bound decode geometry (short chains: every
    # iteration is a host round trip at N=1, so N=4's one fetch per N is
    # the dominant saving)
    mslots = 8
    budget = 64 if on_gpu else 32
    rng = np.random.default_rng(5)
    mprompts = [rng.integers(0, vocab, (int(rng.integers(12, 24)),))
                for _ in range(mslots)]

    def multistep_engine(n):
        return Engine(model, device=model.device, max_slots=mslots,
                      num_pages=(mslots + 2) * cfg.max_position // 16 + 1,
                      page_size=16, chunk_size=8 if on_gpu else 1,
                      max_chain=1, multi_step=n)

    engines = {}
    for n in (1, 4):
        engines[n] = multistep_engine(n)
        for _ in range(2):  # warm every bucket and depth
            [engines[n].add_request(p, budget) for p in mprompts]
            engines[n].run()
    # interleaved pairs, the median of the per-pair ratios: back-to-back
    # N=1/N=4 samples share the host's transient load
    pairs = [(_decode_rate(engines[1], mprompts, budget),
              _decode_rate(engines[4], mprompts, budget))
             for _ in range(5)]
    rates = {1: sorted(p[0] for p in pairs)[2],
             4: sorted(p[1] for p in pairs)[2]}
    speedup = sorted(r4 / r1 for r1, r4 in pairs)[2]
    spr = histogram_summary("paddle_tpu_engine_steps_per_roundtrip")
    out.update({
        "slo_multistep1_decode_tokens_per_sec": round(rates[1], 1),
        "slo_multistep4_decode_tokens_per_sec": round(rates[4], 1),
        "multistep_speedup": round(speedup, 3),
        "multistep_speedup_ok": bool(speedup >= 1.2),
        "multistep_max_steps_per_roundtrip": spr.get("max", 0.0),
    })
    del engines

    # -- open-loop SLO ----------------------------------------------------
    slots = 8 if on_gpu else 4
    qps = 40.0 if on_gpu else 6.0
    n_req = 200 if on_gpu else 24
    ttft_budget_ms = 500.0 if on_gpu else 1500.0
    tpot_budget_ms = 50.0 if on_gpu else 300.0
    budget = 8 if on_gpu else 4

    eng = Engine(model, device=model.device, max_slots=slots,
                 num_pages=(slots + 2) * cfg.max_position // 16 + 1,
                 page_size=16, chunk_size=8 if on_gpu else 2,
                 max_chain=2, multi_step=4)
    # a measured window free of first captures: the lattice plus one
    # admission wave (the host surfaces)
    _precompile(eng, seq_buckets=(16, 32))
    r = np.random.default_rng(1)
    [eng.add_request(_mk_prompt(r, vocab, 12, 32), budget)
     for _ in range(slots)]
    eng.run()
    fe = ServingFrontend(eng).start()
    ol = run_open_loop(fe, qps=qps, n_requests=n_req, vocab=vocab,
                       prompt_range=(12, 32), budget=budget, seed=9)
    fe.shutdown()
    slo_ok = (ol["ttft_p99_ms"] <= ttft_budget_ms
              and ol["tpot_p99_ms"] <= tpot_budget_ms
              and ol["sustained_qps"] >= 0.8 * qps)
    out.update({
        "slo_qps_target": qps,
        "slo_qps_sustained": round(ol["sustained_qps"], 2),
        "slo_p99_ttft_ms": round(ol["ttft_p99_ms"], 1),
        "slo_p99_tpot_ms": round(ol["tpot_p99_ms"], 1),
        "slo_ttft_budget_ms": ttft_budget_ms,
        "slo_tpot_budget_ms": tpot_budget_ms,
        "slo_ok": bool(slo_ok),
    })

    # -- tenant fairness --------------------------------------------------
    weights = {"interactive": 8.0, "batch": 1.0}
    i_qps = 10.0 if on_gpu else 3.0
    n_int = 60 if on_gpu else 12
    batch_budget = 128 if on_gpu else 48

    def fairness_run(flood: bool) -> Dict:
        eng = Engine(model, device=model.device, max_slots=slots,
                     num_pages=(2 * slots + 4) * cfg.max_position // 16
                     + 1,
                     page_size=16, chunk_size=8 if on_gpu else 2,
                     max_chain=2, multi_step=4)
        # warm before the measured window (the front end's thread is not
        # running yet): the lattice, both tenants' prompt buckets and one
        # mixed admission wave
        _precompile(eng, seq_buckets=(16, 64))
        wr = np.random.default_rng(3)
        [eng.add_request(_mk_prompt(wr, vocab, lo, hi), 4)
         for lo, hi in ((48, 64), (9, 16))]
        eng.run()
        fe = ServingFrontend(eng, tenant_weights=weights).start()
        batch_tickets = []
        if flood:
            r = np.random.default_rng(13)
            for i in range(4 * slots):
                batch_tickets.append(fe.submit(
                    _mk_prompt(r, vocab, 48, 64), batch_budget,
                    tenant="batch", seed=100 + i))
        stats = run_open_loop(fe, qps=i_qps, n_requests=n_int,
                              vocab=vocab, prompt_range=(9, 16),
                              budget=4, tenant="interactive", seed=17)
        for t in batch_tickets:
            t.result(timeout=600.0)
        fe.shutdown()
        return stats

    alone = fairness_run(flood=False)
    flooded = fairness_run(flood=True)
    # the unloaded p99 over a small sample is its max sample, scheduler
    # jitter; the floor is a couple of engine steps
    floor_ms = 20.0 if on_gpu else 50.0
    baseline = max(alone["ttft_p99_ms"], floor_ms)
    degrade = (flooded["ttft_p99_ms"] / baseline if baseline else 0.0)
    out.update({
        "fairness_interactive_p99_ttft_ms_alone":
            round(alone["ttft_p99_ms"], 1),
        "fairness_interactive_p99_ttft_ms_flooded":
            round(flooded["ttft_p99_ms"], 1),
        "fairness_baseline_floor_ms": floor_ms,
        "fairness_ttft_degrade": round(degrade, 3),
        "fairness_ok": bool(0.0 < degrade < 2.0),
    })
    return out


# -------------------------------------------------------------- tracing
def bench_trace_serving(cfg, on_gpu: bool) -> Dict:
    """The span recorder's steady-state cost: interleaved (off, on) pairs
    of median scheduling-step times on the SLO bench's geometry, each
    median floored at the host jitter floor (20 ms on the card, 50 ms on
    the CPU) before the ratio. The gate is ``trace_overhead_frac``
    (median on / median off - 1) < 2% with spans recorded."""
    from ..inference.engine import Engine
    from ..observability import metric_total
    from ..observability.tracing import TRACER, configure_tracing

    model = _bench_model(cfg, on_gpu)
    vocab = cfg.vocab_size
    slots = 4
    eng = Engine(model, device=model.device, max_slots=slots,
                 num_pages=(slots + 2) * cfg.max_position // 16 + 1,
                 page_size=16, chunk_size=8 if on_gpu else 2,
                 max_chain=2, multi_step=4)
    rng = np.random.default_rng(21)

    def workload():
        return [eng.add_request(_mk_prompt(rng, vocab, 12, 32), 8)
                for _ in range(slots)]

    spans0 = metric_total("paddle_tpu_trace_spans_total")
    # warm up under both modes: every program, both record paths
    for mode in ("on", "off"):
        configure_tracing(mode, process="bench")
        workload()
        eng.run()
    reps, steps = 4, {"off": [], "on": []}
    try:
        for _ in range(reps):
            for mode in ("off", "on"):
                configure_tracing(mode, process="bench")
                workload()
                while True:
                    t0 = time.perf_counter()
                    live = eng.step()
                    steps[mode].append(time.perf_counter() - t0)
                    if not live:
                        break
    finally:
        configure_tracing("off")
        TRACER.clear()
    floor_s = 0.020 if on_gpu else 0.050
    med_off = float(np.median(steps["off"]))
    med_on = float(np.median(steps["on"]))
    ratio = max(med_on, floor_s) / max(med_off, floor_s)
    overhead = max(0.0, ratio - 1.0)
    spans = int(metric_total("paddle_tpu_trace_spans_total") - spans0)
    ok = overhead < 0.02 and spans > 0
    if not ok:
        print(f"WARNING: bench_trace gate failed: overhead="
              f"{overhead:.4f} (<0.02 required), spans={spans} (>0)")
    return {
        "trace_overhead_frac": round(overhead, 4),
        "trace_step_ms_off": round(1e3 * med_off, 3),
        "trace_step_ms_on": round(1e3 * med_on, 3),
        "trace_jitter_floor_ms": 1e3 * floor_s,
        "trace_bench_spans": spans,
        "trace_ok": bool(ok),
    }


# ------------------------------------------------------------- failover
def bench_failover_serving(cfg, on_gpu: bool) -> Dict:
    """Open-loop load over a two-replica router with one replica killed
    mid-window. Gates: every request completes (no growth of
    ``request_failures_total``: the killed replica's streams migrate), and
    the p99 TTFT of the streams not migrated degrades < 2x against a run
    with no kill, in interleaved (baseline, kill) pairs over a jitter
    floor. Replicas are warmed first and restarts draw warm engines from a
    standby pool, so no window pays a first capture."""
    from ..inference.engine import Engine
    from ..observability import metric_total
    from .replica import InProcReplica
    from .router import Router

    model = _bench_model(cfg, on_gpu)
    vocab = cfg.vocab_size
    slots = 4
    qps = 20.0 if on_gpu else 6.0
    n_req = 60 if on_gpu else 16
    budget = 16
    pairs = 3

    def warm_frontend():
        # the slow-step point holds a decode step at ~12 ms or more, so
        # streams last long enough for the kill to land on a replica
        # with work in flight
        eng = Engine(model, device=model.device, max_slots=slots,
                     num_pages=(slots + 2) * cfg.max_position // 16 + 1,
                     page_size=16, chunk_size=1, max_chain=1,
                     multi_step=1,
                     fault_plan="slow-step:every=1,delay_ms=12")
        _precompile(eng, seq_buckets=(16, 32))
        r = np.random.default_rng(11)
        [eng.add_request(_mk_prompt(r, vocab, 12, 32), 2)
         for _ in range(2)]
        eng.run()
        return ServingFrontend(eng)

    # a warm standby pool: one a replica and one a planned restart
    standby: deque = deque(warm_frontend() for _ in range(2 + pairs))
    factory = (lambda: standby.popleft() if standby
               else warm_frontend())

    reps = [InProcReplica(factory, name=f"bench-r{i}", index=i)
            for i in range(2)]
    router = Router(reps, heartbeat_s=0.05, stall_s=None,
                    restart_dead=True, restart_backoff_s=0.05)
    router.start()

    def one_run(kill: bool, seed: int) -> Dict:
        rng = np.random.default_rng(seed)
        tickets = []
        gaps = rng.exponential(1.0 / qps, size=n_req)
        t0 = time.perf_counter()
        killer = None
        if kill:
            def kill_one():
                # past a third of the window, on a replica with work in
                # flight
                deadline = t0 + 0.8 * n_req / qps
                victim = max(reps, key=lambda r: r.inflight)
                while time.perf_counter() < deadline:
                    victim = max(reps, key=lambda r: r.inflight)
                    if victim.inflight >= 1 and time.perf_counter() \
                            >= t0 + 0.3 * n_req / qps:
                        break
                    time.sleep(0.02)
                victim.kill()

            killer = threading.Thread(target=kill_one, daemon=True)
            killer.start()
        next_at = t0
        for i in range(n_req):
            next_at += gaps[i]
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tickets.append(router.submit(
                _mk_prompt(rng, vocab, 12, 32), budget, seed=seed + i))
        for t in tickets:
            t.result(timeout=300.0)
        if killer is not None:
            killer.join(timeout=60.0)
            # wait out the supervised restart, so the next pair starts
            # from two live replicas
            deadline = time.perf_counter() + 120.0
            while time.perf_counter() < deadline:
                if all(r.alive() for r in reps):
                    break
                time.sleep(0.1)
        unaffected = [t for t in tickets if t.migrations == 0]
        ttft = [t.ttft_s for t in unaffected if t.ttft_s is not None]
        return {
            "completed": sum(1 for t in tickets
                             if t.done and not t.failure_reason),
            "requests": len(tickets),
            "migrated": sum(1 for t in tickets if t.migrations),
            "p99_ttft_ms": 1e3 * _percentile(ttft, 99),
        }

    fail0 = metric_total("paddle_tpu_request_failures_total")
    floor_ms = 20.0 if on_gpu else 50.0
    runs = []
    try:
        for p in range(pairs):
            base = one_run(kill=False, seed=100 + 10 * p)
            killed = one_run(kill=True, seed=500 + 10 * p)
            runs.append((base, killed))
    finally:
        router.shutdown()
        for fe in standby:
            fe.shutdown()
    ratios = sorted(
        k["p99_ttft_ms"] / max(b["p99_ttft_ms"], floor_ms)
        for b, k in runs)
    degrade = ratios[pairs // 2]
    completed = sum(k["completed"] for _, k in runs)
    requests = sum(k["requests"] for _, k in runs)
    migrated = sum(k["migrated"] for _, k in runs)
    return {
        "failover_requests_per_run": n_req,
        "failover_qps": qps,
        "failover_baseline_p99_ttft_ms": round(
            sorted(b["p99_ttft_ms"] for b, _ in runs)[pairs // 2], 1),
        "failover_killed_p99_ttft_ms": round(
            sorted(k["p99_ttft_ms"] for _, k in runs)[pairs // 2], 1),
        "failover_ttft_floor_ms": floor_ms,
        "failover_ttft_degrade": round(degrade, 3),
        "failover_migrated_streams": migrated,
        "failover_completed": completed,
        "failover_zero_failures": bool(
            completed == requests
            and metric_total("paddle_tpu_request_failures_total")
            == fail0),
        "failover_migrations_total": int(
            metric_total("paddle_tpu_router_migrations_total")),
        "failover_replica_restarts_total": int(
            metric_total("paddle_tpu_replica_restarts_total")),
        "failover_ok": bool(degrade < 2.0 and completed == requests
                            and migrated >= 1),
    }


def bench_cluster_serving(cfg, on_gpu: bool) -> Dict:
    """Shared-prefix tenants over a three-replica prefill/decode cluster.
    Gates: zero stream failures (the pooled fleet, the unpooled baseline
    and the oracle); the fleet's prefix hit rate within 1.2x of ONE engine
    that holds every tenant's prefix (the oracle); the pooled p99 TTFT
    under 2x the unpooled fleet's over the jitter floor."""
    from ..inference.engine import Engine
    from ..observability import metric_total
    from .replica import InProcReplica
    from .router import Router

    model = _bench_model(cfg, on_gpu)
    vocab = cfg.vocab_size
    slots = 4
    page = 16
    qps = 20.0 if on_gpu else 6.0
    n_req = 64 if on_gpu else 24
    budget = 8
    tenants = 4
    rng0 = np.random.default_rng(7)
    # one fixed 2-page prefix a tenant: the unit every placement and
    # caching claim is about
    prefixes = [_mk_prompt(rng0, vocab, 2 * page, 2 * page + 1)
                for _ in range(tenants)]

    def warm_engine(num_pages):
        eng = Engine(model, device=model.device, max_slots=slots,
                     num_pages=num_pages, page_size=page, chunk_size=1,
                     max_chain=1, prefix_cache=True)
        _precompile(eng, seq_buckets=(64,))
        return eng

    fleet_pages = (slots + 2) * cfg.max_position // page + 1

    def hit_rate_delta(h0, m0):
        dh = metric_total("paddle_tpu_prefix_cache_hits_total") - h0
        dm = metric_total("paddle_tpu_prefix_cache_misses_total") - m0
        return dh / (dh + dm) if (dh + dm) else 0.0

    def workload(submit, seed):
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / qps, size=n_req)
        tickets = []
        next_at = time.perf_counter()
        for i in range(n_req):
            next_at += gaps[i]
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            prompt = np.concatenate([prefixes[i % tenants],
                                     _mk_prompt(rng, vocab, 8, 17)])
            tickets.append(submit(prompt, budget,
                                  tenant=f"t{i % tenants}"))
        for t in tickets:
            t.result(timeout=300.0)
        ttft = [t.ttft_s for t in tickets if t.ttft_s is not None]
        return {
            "completed": sum(1 for t in tickets
                             if t.done and not t.failure_reason),
            "requests": len(tickets),
            "p99_ttft_ms": 1e3 * _percentile(ttft, 99),
        }

    fail0 = metric_total("paddle_tpu_request_failures_total")

    # --- the unpooled baseline: three engines, each prefills and decodes
    base_reps = [InProcReplica(
        lambda: ServingFrontend(warm_engine(fleet_pages)),
        name=f"base-r{i}", index=i) for i in range(3)]
    base_router = Router(base_reps, heartbeat_s=0.05,
                         stall_s=None).start()
    try:
        base = workload(base_router.submit, seed=100)
    finally:
        base_router.shutdown()
    del base_reps, base_router

    # --- the pooled cluster: 1 prefill + 2 decode, the KV handoff between
    reps = [InProcReplica(
        lambda: ServingFrontend(warm_engine(fleet_pages)),
        name=f"cluster-r{i}", index=i) for i in range(3)]
    router = Router(reps, heartbeat_s=0.05, stall_s=None,
                    pools={"prefill": 1, "decode": 2}).start()
    try:
        deadline = time.perf_counter() + 30.0
        while router.cluster._page_size is None \
                and time.perf_counter() < deadline:
            time.sleep(0.02)  # one sweep feeds the geometry into the view
        h0 = metric_total("paddle_tpu_prefix_cache_hits_total")
        m0 = metric_total("paddle_tpu_prefix_cache_misses_total")
        ho0 = metric_total("paddle_tpu_cluster_handoffs_total")
        hb0 = metric_total("paddle_tpu_cluster_handoff_bytes_total")
        fb0 = metric_total("paddle_tpu_cluster_fallbacks_total")
        pooled = workload(router.submit, seed=200)
        pooled_rate = hit_rate_delta(h0, m0)
        handoffs = metric_total("paddle_tpu_cluster_handoffs_total") - ho0
        handoff_mb = (metric_total("paddle_tpu_cluster_handoff_bytes_total")
                      - hb0) / 2 ** 20
        fallbacks = metric_total("paddle_tpu_cluster_fallbacks_total") - fb0
    finally:
        router.shutdown()
    del reps, router

    # --- the oracle: ONE engine whose cache holds the whole fleet's
    # prefixes, the bound the fleet's hit rate is judged against
    oracle_fe = ServingFrontend(warm_engine(4 * fleet_pages)).start()
    try:
        h0 = metric_total("paddle_tpu_prefix_cache_hits_total")
        m0 = metric_total("paddle_tpu_prefix_cache_misses_total")
        oracle = workload(oracle_fe.submit, seed=300)
        oracle_rate = hit_rate_delta(h0, m0)
    finally:
        oracle_fe.shutdown()

    floor_ms = 20.0 if on_gpu else 50.0
    degrade = (pooled["p99_ttft_ms"]
               / max(base["p99_ttft_ms"], floor_ms))
    completed = (base["completed"] + pooled["completed"]
                 + oracle["completed"])
    requests = (base["requests"] + pooled["requests"]
                + oracle["requests"])
    zero_failures = bool(
        completed == requests
        and metric_total("paddle_tpu_request_failures_total") == fail0)
    hit_ok = bool(pooled_rate * 1.2 >= oracle_rate)
    out = {
        "cluster_requests_per_run": n_req,
        "cluster_tenants": tenants,
        "cluster_qps": qps,
        "cluster_hit_rate": round(pooled_rate, 3),
        "cluster_oracle_hit_rate": round(oracle_rate, 3),
        "cluster_hit_rate_ok": hit_ok,
        "cluster_p99_ttft_ms": round(pooled["p99_ttft_ms"], 1),
        "cluster_baseline_p99_ttft_ms": round(base["p99_ttft_ms"], 1),
        "cluster_ttft_floor_ms": floor_ms,
        "cluster_ttft_degrade": round(degrade, 3),
        "cluster_handoffs": int(handoffs),
        "cluster_handoff_mb": round(handoff_mb, 3),
        "cluster_fallbacks": int(fallbacks),
        "cluster_zero_failures": zero_failures,
        "cluster_ok": bool(hit_ok and degrade < 2.0 and zero_failures),
    }
    if not out["cluster_ok"]:
        print(f"WARNING: cluster serving gate failed: hit_rate="
              f"{pooled_rate:.3f} vs oracle {oracle_rate:.3f} (1.2x), "
              f"ttft_degrade={degrade:.3f} (<2.0), "
              f"zero_failures={zero_failures}")
    return out
