"""Load generation that drives a serving front end, after
``paddle_tpu/serving/loadgen.py`` (its open- and closed-loop load runs; the
reference's ``bench_*`` functions feed its ``bench.py`` and are not
ported).

* **Open loop**: Poisson arrivals at a target QPS, submitted on wall
  deadlines regardless of completions (the discipline that exposes
  queueing collapse).
* **Closed loop**: fixed concurrency, the next request on a completion
  (steady-state throughput at a given parallelism).

Latency is measured host-side per ticket (submit to first chunk TTFT,
decode-tail TPOT): exact per request rather than bucketed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .frontend import ServingFrontend

__all__ = ["run_open_loop", "run_closed_loop"]


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
