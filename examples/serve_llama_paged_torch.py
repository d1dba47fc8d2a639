"""LLaMA serving through the PyTorch/CUDA port's continuous-batching engine
(``paddle_tpu_torch.inference.Engine`` over the paged KV cache): the twin
of ``serve_llama_paged.py``'s single-engine path.

Sequences of different lengths share one page pool, a finished request's
pages recycle into the next admission mid-flight, and tokens stream back
per chain. With ``--api-port`` the engine serves the OpenAI-compatible
streaming HTTP API (``paddle_tpu_torch.serving``) until SIGTERM, then
drains.

Run on the card (the default device):
    python examples/serve_llama_paged_torch.py
    python examples/serve_llama_paged_torch.py --model llama2_7b --api-port 8000
Run on the CPU (tiny):
    python examples/serve_llama_paged_torch.py --tiny --device cpu
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
    ap.add_argument("--spec", choices=["off", "ngram"], default="off",
                    help="speculative decoding by prompt lookup; greedy "
                         "output is identical to --spec off")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify step")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="on",
                    help="refcounted copy-on-write prefix caching: "
                         "admissions splice cached block-aligned prefixes "
                         "and prefill only the uncached suffix")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: stream prompts into the cache "
                         "this many tokens per mixed chunk+decode step")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTL: a request not finished this "
                         "many ms after submission fails with reason "
                         "'deadline', queued or mid-decode")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded wait queue: add_request raises "
                         "QueueFull once this many requests wait")
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
    args = ap.parse_args()

    from paddle_tpu_torch.inference.engine import Engine

    cfg, model = _model(args)
    big = cfg.hidden_size >= 4096
    eng = Engine(model, max_slots=8 if big else 4,
                 num_pages=1024 if big else 96, page_size=16,
                 chunk_size=16 if big else 8,
                 quantized_cache=args.int8_cache,
                 spec=None if args.spec == "off" else args.spec,
                 spec_k=args.spec_k,
                 deadline_s=(args.deadline_ms / 1e3
                             if args.deadline_ms is not None else None),
                 max_queue=args.max_queue,
                 prefix_cache=args.prefix_cache == "on",
                 prefill_chunk=args.prefill_chunk,
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
