#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase, as the chip check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, in order; any failure exits non-zero:

1. build    — nvcc builds every kernel of ``paddle_tpu_torch/csrc`` (one
              process per source, all at once); prints the build seconds
              and the card's name and power limit.
2. kernels  — each kernel against its plain PyTorch version at the main
              path's shapes (``llama2_7b`` widths), with the tolerance
              stated; kernel, plain and library times by CUDA events.
3. main     — ``llama2_7b`` at full width and depth, bf16, random weights
              from a seed, served through the port's ``Engine``: sampled and
              greedy requests, an int8-page pass, and a pool small enough to
              force a preemption. The launch counters are zeroed just
              before and read just after.
4. greedy   — a 2-layer full-width f32 model: the engine's greedy streams
              against the argmax of the port's own cacheless forward.

Opt-in: ``--phases build,profile`` times one 7B decode chain and lists
the device kernels under torch.profiler (PERF.md "Where the time goes").

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or paddle_tpu.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
PHASES = ("build", "kernels", "main", "greedy")
OPTIONAL_PHASES = ("profile",)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, reps=10):
    """Median CUDA-event milliseconds of ``fn()`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gpu_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1
def phase_build():
    from paddle_tpu_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + " ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
    for name in secs:
        rep = build.ptxas_report(name)
        lines = [ln for ln in rep.splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in lines[:24]:
            log(f"  ptxas[{name}] {ln.strip()}")


# ------------------------------------------------------------ phase 2
def _decode_case(torch, dtype, quant, B, H, Hkv, D, ps, max_pages,
                 lengths, seed):
    from paddle_tpu_torch.ops.cuda.paged_attention import quantize_rows_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    P = 1 + B * max_pages
    shape = (P, ps, Hkv * D)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    scale_pages = None
    if quant:
        kq, ks = quantize_rows_int8(k.view(P, ps, Hkv, D))
        vq, vs = quantize_rows_int8(v.view(P, ps, Hkv, D))
        scale_pages = torch.zeros((P, ps, 128), dtype=torch.bfloat16,
                                  device=dev)
        scale_pages[..., :Hkv] = ks.to(torch.bfloat16)
        scale_pages[..., Hkv:2 * Hkv] = vs.to(torch.bfloat16)
        k, v = kq.view(shape), vq.view(shape)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = perm[:B * max_pages].view(B, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, tables, lens, scale_pages


def check_decode(torch, dtype, quant, B, H, Hkv, D, ps, max_pages, lengths,
                 atol, rtol, timed):
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    q, k, v, tables, lens, sc = _decode_case(
        torch, dtype, quant, B, H, Hkv, D, ps, max_pages, lengths, 1)
    got = pa.paged_slab_decode_attention(q, k, v, tables, lens, H,
                                         scale_pages=sc)
    torch.cuda.synchronize()
    want = pa.paged_slab_decode_attention_ref(q, k, v, tables, lens,
                                              scale_pages=sc)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"paged decode {dtype} quant={quant}: max abs "
                             f"err {err} beyond atol={atol} rtol={rtol}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("paged decode produced non-finite values")
    zero_rows = (lens == 0).nonzero().flatten().tolist()
    for r in zero_rows:
        if got[r].abs().max().item() != 0.0:
            raise AssertionError("a length-0 row must give zeros")
    rec = {"max_abs_err": err}
    if timed:
        cap = max_pages * ps
        live = sum(min(max(n, 0), cap) for n in lengths)
        kv_elem = 1 if quant else k.element_size()
        nbytes = (2 * q.numel() * q.element_size()            # q in, out
                  + 2 * live * Hkv * D * kv_elem               # K and V
                  + (live * 2 * Hkv * 2 if quant else 0)       # k/v scales
                  + tables.numel() * 4 + lens.numel() * 4)
        flops = 4 * live * (H // Hkv) * Hkv * D
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / BF16_FLOPS_PER_S * 1e3
        rec.update(
            ms=time_ms(lambda: pa.paged_slab_decode_attention(
                q, k, v, tables, lens, H, scale_pages=sc)),
            plain_ms=time_ms(lambda: pa.paged_slab_decode_attention_ref(
                q, k, v, tables, lens, scale_pages=sc), warmup=1, reps=3),
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None)
    return rec


def check_flash(torch, dtype, B, S, H, D, atol, rtol, timed):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
               for _ in range(3))
    got, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=True,
                                            return_lse=True)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"flash {dtype} S={S}: max abs err {err} "
                             f"beyond atol={atol} rtol={rtol}")
    lerr = (lse - want_lse).abs().max().item()
    if lerr > 1e-3:
        raise AssertionError(f"flash lse max abs err {lerr}")
    rec = {"max_abs_err": err}
    if timed:
        pairs = S * (S + 1) // 2
        flops = 4 * B * H * D * pairs
        nbytes = 4 * B * S * H * D * q.element_size()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        b_ops = flops / peak * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec.update(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            plain_ms=time_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal=True), warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)))
    return rec


def phase_kernels():
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    # llama2_7b decode: B=8 slots, H=Hkv=32, D=128, page 16, 256 pages per
    # sequence (max_position 4096); ragged lengths with 0 and the cap
    lengths = [0, 1, 17, 300, 1000, 2049, 3333, 4096]
    dec = dict(B=8, H=32, Hkv=32, D=128, ps=16, max_pages=256,
               lengths=lengths)
    results = {}
    tol = dict(atol=2e-2, rtol=2e-2)
    r = check_decode(torch, bf16, False, timed=True, **dec, **tol)
    log(f"kernel paged_decode_attention bf16 B=8 H=32 D=128 ps=16 "
        f"lengths={lengths}: max_abs_err={r['max_abs_err']:.3g} "
        f"(atol 2e-2 rtol 2e-2) ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']})")
    results["paged_decode_attention"] = r
    r8 = check_decode(torch, bf16, True, timed=True, **dec, **tol)
    log(f"kernel paged_decode_attention int8 pages, same shapes: "
        f"max_abs_err={r8['max_abs_err']:.3g} (atol 2e-2 rtol 2e-2) "
        f"ms={r8['ms']:.4f} plain_ms={r8['plain_ms']:.3f} "
        f"bound_ms={r8['bound_ms']:.4f} ({r8['bound_by']})")
    r32 = check_decode(torch, f32, False, timed=False, B=2, H=32, Hkv=32,
                       D=128, ps=16, max_pages=16, lengths=[0, 200],
                       atol=1e-4, rtol=1e-4)
    log(f"kernel paged_decode_attention f32: max_abs_err="
        f"{r32['max_abs_err']:.3g} (atol 1e-4 rtol 1e-4)")
    # B=8 S=1024 is the main path's largest prefill wave (8 rows padded to
    # the 1024 bucket); S=1000 is a ragged edge
    for B, S in ((2, 512), (2, 1000), (8, 1024)):
        rf = check_flash(torch, bf16, B, S, 32, 128, timed=True, **tol)
        log(f"kernel flash_attention_fwd bf16 B={B} S={S} H=32 D=128 "
            f"causal: max_abs_err={rf['max_abs_err']:.3g} (atol 2e-2 rtol "
            f"2e-2) ms={rf['ms']:.4f} plain_ms={rf['plain_ms']:.3f} "
            f"bound_ms={rf['bound_ms']:.4f} ({rf['bound_by']}) "
            f"library_ms(sdpa)={rf['library_ms']:.4f}")
    results["flash_attention_fwd"] = rf  # the main path's B=8 S=1024
    rf32 = check_flash(torch, f32, 1, 77, 32, 128, atol=1e-4, rtol=1e-4,
                       timed=False)
    log(f"kernel flash_attention_fwd f32 S=77: max_abs_err="
        f"{rf32['max_abs_err']:.3g} (atol 1e-4 rtol 1e-4)")
    return results


KERNELS = {
    "paged_decode_attention": dict(
        source="paddle_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:446"),
    "flash_attention_fwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:136"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPTIONAL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: paddle_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    ident = gpu_identity()
    log(f"card: {ident}")
    kernel_stats, launches = {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernel_stats = phase_kernels()
    if "main" in phases:
        launches = phase_main(ident)
    if "greedy" in phases:
        phase_greedy(ident)
    if "profile" in phases:
        phase_profile(ident)
    rows = []
    for name, meta in KERNELS.items():
        st = kernel_stats.get(name, {})
        rows.append({"name": name, "route": "cuda", **meta,
                     "launches": launches.get(name),
                     "max_abs_err": st.get("max_abs_err"),
                     "ms": st.get("ms"), "plain_ms": st.get("plain_ms"),
                     "bound_ms": st.get("bound_ms"),
                     "bound_by": st.get("bound_by"),
                     "library_ms": st.get("library_ms")})
    log("kernels: " + ", ".join(KERNELS))
    log(f"card: {ident}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _serve(engine, specs, rng, vocab):
    """Queue ``specs`` [(prompt_len, new_tokens, temperature, seed)] and
    run the engine to completion; fail unless every request finished with
    its full budget. Returns (requests, wall seconds)."""
    import torch

    reqs = [engine.add_request(rng.integers(0, vocab, (n,)), m,
                               temperature=t, seed=s)
            for n, m, t, s in specs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, (n, m, t, s) in zip(reqs, specs):
        if r.failed or not r.done or len(r.tokens) != m:
            raise AssertionError(
                f"request {r.rid} (prompt {n}, temp {t}) ended "
                f"{r.state} reason={r.failure_reason} with "
                f"{len(r.tokens)}/{m} tokens")
    return reqs, wall


def _report(tag, reqs, wall, ident):
    ttft = sorted((r._t_first - r._t_arrival) * 1e3 for r in reqs)
    toks = sum(len(r.tokens) for r in reqs)
    log(f"{tag}: {len(reqs)} requests, {toks} tokens in {wall:.3f} s = "
        f"{toks / wall:.1f} tok/s; TTFT ms median "
        f"{statistics.median(ttft):.1f} max {ttft[-1]:.1f} [{ident}]")


def phase_main(ident):
    """llama2_7b at full width and depth, bf16, through the Engine."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    cfg = llama2_7b()
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main: llama2_7b {cfg.num_params() / 1e9:.2f}B params bf16 "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    pa.paged_slab_decode_attention.launches = 0

    # pass 1: 10 mixed requests, two of them sampled
    specs = [(16, 64, 0.0, None), (1024, 32, 0.0, None),
             (300, 128, 0.8, 11), (64, 96, 0.0, None),
             (700, 48, 0.8, 12), (128, 128, 0.0, None),
             (33, 40, 0.0, None), (512, 64, 0.0, None),
             (900, 32, 0.0, None), (200, 80, 0.0, None)]
    eng = Engine(model, max_slots=8, num_pages=1024, page_size=16,
                 chunk_size=16)
    reqs, wall = _serve(eng, specs, rng, cfg.vocab_size)
    _report("main bf16 pages", reqs, wall, ident)
    del eng
    torch.cuda.empty_cache()

    # pass 2: int8 KV pages
    specs8 = [(100, 48, 0.0, None), (600, 32, 0.8, 21),
              (250, 64, 0.0, None), (40, 64, 0.0, None)]
    eng = Engine(model, max_slots=8, num_pages=1024, page_size=16,
                 chunk_size=16, quantized_cache=True)
    reqs, wall = _serve(eng, specs8, rng, cfg.vocab_size)
    _report("main int8 pages", reqs, wall, ident)
    del eng
    torch.cuda.empty_cache()

    # pass 3: a pool too small for the run, forcing recompute preemption
    # (each request needs up to 25 pages; 39 usable pages hold one and a
    # half of them)
    specsp = [(256, 128, 0.0, None), (256, 128, 0.8, 31),
              (200, 96, 0.0, None)]
    eng = Engine(model, max_slots=4, num_pages=40, page_size=16,
                 chunk_size=16)
    reqs, wall = _serve(eng, specsp, rng, cfg.vocab_size)
    _report("main small pool", reqs, wall, ident)
    if eng.preemptions < 1:
        raise AssertionError("the small pool forced no preemption")
    log(f"main small pool: {eng.preemptions} preemptions")
    del eng

    launches = {"paged_decode_attention":
                pa.paged_slab_decode_attention.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches}
    log(f"main: launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{ident}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_profile(ident):
    """Opt-in (not in the default run): where one decode chain's time goes
    at llama2_7b, 8 active slots, bf16. Host wall time of the chain against
    the device's busy time under torch.profiler, and the top device
    kernels by total time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b

    cfg = llama2_7b()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    eng = Engine(model, max_slots=8, num_pages=1024, page_size=16,
                 chunk_size=16, max_chain=1)
    rng = np.random.default_rng(3)
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, (512,)), 200)
    eng.step()  # admission wave + first chain (builds, warms up)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    steps = eng.chunk_size
    log(f"profile: one 16-step chain, 8 slots, ~512-token contexts: wall "
        f"{wall * 1e3:.1f} ms ({wall * 1e3 / steps:.2f} ms/token step); "
        f"device busy {busy_ms:.1f} ms under the profiler "
        f"({busy_ms / steps:.2f} ms/step); {launches} device kernels "
        f"({launches / steps:.0f}/step) [{ident}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")
    del eng, model
    torch.cuda.empty_cache()


def phase_greedy(ident):
    """2-layer full-width f32: engine greedy streams against the argmax of
    the port's own cacheless forward, recomputed token by token. The
    comparison of a request stops at the first position where the
    reference's top-2 logit gap is under 1e-4."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    cfg = LlamaConfig(num_layers=2)
    model = init_llama(cfg, seed=1, device="cuda", dtype=torch.float32)
    eng = Engine(model, max_slots=2, num_pages=128, page_size=16,
                 chunk_size=16)
    rng = np.random.default_rng(1)
    reqs, _ = _serve(eng, [(40, 24, 0.0, None), (150, 24, 0.0, None)],
                     rng, cfg.vocab_size)
    for r in reqs:
        seq = torch.as_tensor(r.prompt, dtype=torch.int64, device="cuda")
        compared = 0
        with torch.no_grad():
            for tok in r.tokens:
                logits = model(seq[None])[0, -1]
                top2 = torch.topk(logits, 2).values
                if (top2[0] - top2[1]).item() < 1e-4:
                    break
                want = int(torch.argmax(logits))
                if want != tok:
                    raise AssertionError(
                        f"request {r.rid}: token {compared} is {tok}, the "
                        f"cacheless forward says {want}")
                compared += 1
                seq = torch.cat([seq, seq.new_tensor([tok])])
        if compared < 16:
            raise AssertionError(f"request {r.rid}: only {compared} tokens "
                                 "compared before a near-tie")
        log(f"greedy: request {r.rid} (prompt {r.prompt.size}) matches the "
            f"cacheless forward on {compared}/{len(r.tokens)} tokens")


if __name__ == "__main__":
    sys.exit(main())
