"""LLaMA serving through the PyTorch/CUDA port's continuous-batching engine
(``paddle_tpu_torch.inference.Engine`` over the paged KV cache): the twin
of ``serve_llama_paged.py``'s single-engine path.

Sequences of different lengths share one page pool, a finished request's
pages recycle into the next admission mid-flight, and tokens stream back
per chain. With ``--api-port`` the engine serves the OpenAI-compatible
streaming HTTP API (``paddle_tpu_torch.serving``) until SIGTERM, then
drains. With ``--pools prefill=K,decode=M`` it runs the cluster smoke
instead: K + M in-process replicas behind one ``Router``, prompts
prefilled on the prefill pool and their KV handed to a decode replica.

Run on the card (the default device):
    python examples/serve_llama_paged_torch.py
    python examples/serve_llama_paged_torch.py --model llama2_7b --api-port 8000
    python examples/serve_llama_paged_torch.py --pools prefill=1,decode=2
    python examples/serve_llama_paged_torch.py --spec draft
Run on the CPU (tiny):
    python examples/serve_llama_paged_torch.py --tiny --device cpu
    python examples/serve_llama_paged_torch.py --tiny --device cpu --spec draft
"""
import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np


def run_api_server(eng, args):
    """Serve the OpenAI-compatible streaming API until SIGTERM/SIGINT, then
    drain: admissions stop, in-flight streams finish inside
    ``--drain-grace``, stragglers are cancelled through ``Engine.cancel``."""
    import asyncio

    from paddle_tpu_torch.serving import (ServingFrontend,
                                          parse_tenant_weights)
    from paddle_tpu_torch.serving.server import ApiServer

    frontend = ServingFrontend(
        eng, tenant_weights=parse_tenant_weights(args.tenant_weights),
        stream_stall_s=(args.stream_stall_ms / 1e3
                        if args.stream_stall_ms is not None else None))
    server = ApiServer(frontend, port=args.api_port,
                       model_name="llama-paged", grace_s=args.drain_grace)

    async def serve():
        await server.start()
        print(f"api: http://127.0.0.1:{server.port}/v1/completions "
              f"(multi_step={args.multi_step}, "
              f"tenants={args.tenant_weights or 'default'})", flush=True)
        await server.serve_until_signal()

    asyncio.run(serve())
    if frontend.fault is not None:
        raise SystemExit(f"engine thread failed: {frontend.fault!r}")


def run_cluster_smoke(model, cfg, args):
    """``--pools prefill=K,decode=M``: an in-process prefill/decode fleet
    behind one Router. Prompts prefill on the prefill pool, their KV ships
    to a decode replica (digest-verified; recompute on any failure), and
    shared-prefix streams converge on warm decode replicas. Prints the
    handoff and fallback counters."""
    import time

    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.observability import metric_total
    from paddle_tpu_torch.serving import (InProcReplica, Router,
                                          ServingFrontend, parse_pools)

    pools = parse_pools(args.pools)
    n = sum(pools.values())

    def factory():
        eng = Engine(model, max_slots=4, num_pages=96, page_size=16,
                     chunk_size=8, prefix_cache=True, device=args.device)
        return ServingFrontend(eng)

    reps = [InProcReplica(factory, name=f"pool-r{i}", index=i)
            for i in range(n)]
    router = Router(reps, heartbeat_s=0.05, stall_s=None,
                    pools=pools, fault_plan=args.fault_inject)
    router.start()
    try:
        deadline = time.perf_counter() + 60.0
        while router.cluster._page_size is None \
                and time.perf_counter() < deadline:
            time.sleep(0.05)  # a sweep feeds the geometry into the view
        rng = np.random.default_rng(0)
        shared = rng.integers(0, cfg.vocab_size, (32,))
        tickets = []
        for i in range(6):
            prompt = np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size, (8,))])
            tickets.append(router.submit(prompt, 12, tenant=f"t{i % 2}"))
        for t in tickets:
            t.result(timeout=300.0)
        ok = all(t.failure_reason is None for t in tickets)
        roles = {r.name: router.cluster.role_of(r) for r in reps}
        print(f"cluster smoke: pools={pools} roles={roles}")
        print(f"  streams: {len(tickets)} submitted, "
              f"{sum(1 for t in tickets if t.done)} done, ok={ok}")
        print("  handoffs=%d fallbacks=%d shipped_kb=%.1f" % (
            metric_total("paddle_tpu_cluster_handoffs_total"),
            metric_total("paddle_tpu_cluster_fallbacks_total"),
            metric_total("paddle_tpu_cluster_handoff_bytes_total")
            / 1024.0))
        if not ok:
            raise SystemExit("cluster smoke: stream failures")
    finally:
        router.shutdown()


def _draft_model(cfg, model, args):
    """A deliberately tiny draft, the reference example's: one narrow
    layer sharing the target's vocabulary and positions (correctness never
    depends on its quality; greedy acceptance is token-exact against the
    target). Its two heads are 64 wide where the reference's are 16: the
    card's attention kernels take head dims of 32 and up (64 for #3)."""
    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.models.llama import tiny_llama_config

    dcfg = tiny_llama_config(
        num_layers=1, hidden_size=128, num_heads=2, num_kv_heads=2,
        intermediate_size=256, vocab_size=cfg.vocab_size,
        max_position=cfg.max_position)
    return init_llama(dcfg, seed=1, device=args.device, dtype=model.dtype)


def _model(args):
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.models.llama import llama2_7b, tiny_llama_config

    if args.tiny or args.model == "tiny":
        cfg, dtype = tiny_llama_config(), torch.float32
    elif args.model == "llama2_7b":
        cfg, dtype = llama2_7b(), torch.bfloat16
    else:
        cfg, dtype = tiny_llama_config(
            hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=4,
            intermediate_size=512, max_position=512), torch.float32
    model = init_llama(cfg, seed=0, device=args.device, dtype=dtype)
    if args.weight_quant != "none":
        from paddle_tpu_torch.nn.quant import quantize_for_decode

        _, swapped = quantize_for_decode(
            model, algo=f"weight_only_{args.weight_quant}")
        print(f"weight-only {args.weight_quant}: {swapped} Linears swapped")
    return cfg, model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny LLaMA (same as --model tiny)")
    ap.add_argument("--model", choices=["tiny", "small", "llama2_7b"],
                    default="small",
                    help="random weights from seed 0: 'small' is the "
                         "reference example's 4-layer 256-wide LLaMA (f32), "
                         "'llama2_7b' LLaMA-2-7B's widths and depth (bf16)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the kernels run on the "
                         "card) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--int8-cache", action="store_true",
                    help="store KV pages int8 with per-row scales")
    ap.add_argument("--weight-quant", choices=["none", "int8", "int4"],
                    default="none",
                    help="weight-only-quantize the Linears before serving "
                         "(decode-sized GEMMs then run kernel #12)")
    ap.add_argument("--spec", choices=["off", "ngram", "draft"],
                    default="off",
                    help="speculative decoding: 'ngram' drafts by prompt "
                         "lookup (model-free), 'draft' drafts with a "
                         "1-layer llama sharing the vocab; greedy output "
                         "is identical to --spec off, sampled output stays "
                         "distribution-exact via rejection sampling")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify step")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="on",
                    help="refcounted copy-on-write prefix caching: "
                         "admissions splice cached block-aligned prefixes "
                         "and prefill only the uncached suffix")
    ap.add_argument("--kv-host-pages", type=int, default=0,
                    help="host KV tier size in pages (needs --prefix-cache "
                         "on): idle cached pages spill to a pinned host "
                         "slab instead of being evicted, and a later "
                         "chain hit promotes them back digest-checked. 0 "
                         "(the default) is no tier. Output tokens are "
                         "identical either way")
    ap.add_argument("--integrity", choices=["off", "audit", "strict"],
                    default="off",
                    help="silent-data-corruption defense: 'audit' keeps "
                         "weight digests with periodic probes and exact "
                         "KV page checksums verified at every prefix-cache "
                         "splice; 'strict' adds the shadow recompute of "
                         "one greedy row every few steps. A corrupt page "
                         "is contained and recomputed; corrupt weights "
                         "quarantine the engine")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: stream prompts into the cache "
                         "this many tokens per mixed chunk+decode step")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode roles in one step (needs "
                         "--prefill-chunk): mid-prompt slots stream "
                         "chunks through the mixed step while decoding "
                         "slots ride deep chains; output tokens are "
                         "identical either way")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTL: a request not finished this "
                         "many ms after submission fails with reason "
                         "'deadline', queued or mid-decode")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded wait queue: add_request raises "
                         "QueueFull once this many requests wait")
    ap.add_argument("--fault-inject", default=None,
                    help="deterministic fault-injection plan "
                         "(paddle_tpu_torch.testing.faultinject grammar, "
                         "e.g. 'nan-logits:rid=2,times=1'); defaults to "
                         "FLAGS_fault_inject / PADDLE_TPU_FAULT_INJECT. "
                         "Faulted requests end FAILED with a taxonomy "
                         "reason; the engine never dies")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="batch up to N decode iterations behind one host "
                         "round trip in pure-decode phases; streams are "
                         "identical for every N")
    ap.add_argument("--api-port", type=int, default=None,
                    help="serve the OpenAI-compatible streaming HTTP API "
                         "on this port instead of the local demo; 0 picks "
                         "an ephemeral port, printed as 'api: http://...'")
    ap.add_argument("--tenant-weights", default=None,
                    help="weighted fairness map 'name=weight,...' (e.g. "
                         "'interactive=4,batch=1')")
    ap.add_argument("--stream-stall-ms", type=float, default=None,
                    help="cancel a streaming consumer that stops draining "
                         "chunks for this many ms (off by default)")
    ap.add_argument("--drain-grace", type=float, default=30.0,
                    help="SIGTERM drain budget in seconds")
    ap.add_argument("--pools", default=None, metavar="SPEC",
                    help="cluster smoke: run SPEC (e.g. prefill=1,decode=2) "
                         "in-process replicas behind one Router (the "
                         "prefill pool, the KV handoff, cache-aware decode "
                         "placement), print the handoff counters and exit")
    args = ap.parse_args()

    from paddle_tpu_torch.inference.engine import Engine

    cfg, model = _model(args)
    if args.pools is not None:
        run_cluster_smoke(model, cfg, args)
        return
    draft_model = None
    if args.spec == "draft":
        draft_model = _draft_model(cfg, model, args)
    big = cfg.hidden_size >= 4096
    eng = Engine(model, max_slots=8 if big else 4,
                 num_pages=1024 if big else 96, page_size=16,
                 chunk_size=16 if big else 8,
                 quantized_cache=args.int8_cache,
                 spec=None if args.spec == "off" else args.spec,
                 spec_k=args.spec_k, draft_model=draft_model,
                 deadline_s=(args.deadline_ms / 1e3
                             if args.deadline_ms is not None else None),
                 max_queue=args.max_queue,
                 prefix_cache=args.prefix_cache == "on",
                 prefill_chunk=args.prefill_chunk,
                 disaggregate=args.disaggregate,
                 fault_plan=args.fault_inject,
                 kv_host_pages=args.kv_host_pages,
                 integrity=(None if args.integrity == "off"
                            else args.integrity),
                 multi_step=args.multi_step, device=args.device)

    if args.api_port is not None:
        run_api_server(eng, args)
        return

    rng = np.random.default_rng(0)
    # mixed-length requests, more requests than slots: admission interleaves
    # with decode, finished slots recycle their pages for queued requests
    streams = {}
    reqs = []
    for i, (plen, new) in enumerate([(20, 12), (33, 6), (8, 24), (27, 10),
                                     (15, 16), (41, 8)]):
        prompt = rng.integers(0, cfg.vocab_size, (plen,))
        streams[i] = []
        reqs.append(eng.add_request(
            prompt, new, on_token=lambda ts, i=i: streams[i].extend(ts)))

    free0 = len(eng._free_pages)
    rounds = 0
    while eng.step():
        rounds += 1
        print(f"round {rounds}: active={len(eng._active)} "
              f"queued={len(eng._queue)} "
              f"pages_in_use={free0 - len(eng._free_pages)}")
    for i, r in enumerate(reqs):
        assert r.done and streams[i] == r.tokens
        if r.failed:
            print(f"request {r.rid}: prompt {r.prompt.size:>2} -> "
                  f"FAILED ({r.failure_reason}) after {len(r.tokens)} "
                  "tokens")
            continue
        print(f"request {r.rid}: prompt {r.prompt.size:>2} -> "
              f"{len(r.tokens)} tokens (streamed {len(streams[i])})")
    resident = eng._pcache.n_pages if eng._pcache is not None else 0
    print(f"pool fully recycled: {len(eng._free_pages)}+{resident} cached "
          f"of {free0} (int8_cache={args.int8_cache})")
    if eng._spec is not None:
        s = eng._spec.stats()
        print(f"spec[{s['drafter']}] k={s['k']}: "
              f"{s['accept_per_step']:.2f} tokens/verify-step, "
              f"accept rate {s['accept_rate']:.2f}")


if __name__ == "__main__":
    main()
