#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one H100.

    python3 chip_smoke.py            # every phase, as the chip check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, in order; any failure exits non-zero:

1. build    — nvcc builds every kernel of ``paddle_tpu_torch/csrc`` (one
              process per source, all at once); prints the build seconds
              and the card's name and power limit.
2. kernels  — each kernel against its plain PyTorch version at the main
              path's shapes (``llama2_7b`` widths; Mixtral-8x7B widths for
              the grouped expert matmul and the GQA timings; GPT-medium
              widths for the flash backward on the general and the packed
              layouts and for the forward on the packed views; GPT-2 small
              and ``llama2_7b`` widths for the decode kernels #4, #14,
              #15; TinyLlama-1.1B's GQA 32/4 at D=64 for #1 and #3, the
              draft pass's shapes), with the tolerance stated; kernel, plain and library
              times by CUDA events.
3. context  — context parallelism at ``llama2_7b``'s attention widths:
              the position-masked forms of #2 and #6 against their plain
              twins on the 16 chunk pairs of a four-rank zig-zag ring over
              16384 tokens (bf16 and f32, timed against SDPA with the
              boolean mask); the four-rank schedule in one process against
              full causal attention, forward and gradients; then the path,
              ``fleet.init`` (``sep_degree=1``) on a one-rank NCCL world
              and ``ring_flash_attention`` forward + backward on bf16
              ``[1, 16384, 32, 128]`` in a zig-zag layout, held against
              the materialized-logits ring (``impl="xla"``) at 4096.
4. main     — ``llama2_7b`` at full width and depth, bf16, random weights
              from a seed, served through the port's ``Engine``: sampled and
              greedy requests, an int8-page pass, a pool small enough to
              force a preemption, and the three modes that ride the verify
              kernel (prefix cache, chunked prefill, n-gram speculative
              decoding). Pass A serves it again with weight-only int8 and
              int4 weights (kernel #12); pass B builds a LLaMA-MoE at
              Mixtral-8x7B-v0.1 widths, 16 of its 32 layers, and serves it
              (kernel #13). The engines run their decode chains and
              verify steps as CUDA graph replays (``inference/runner.py``);
              the bf16 pass (1), the int8-weight pass, the spec pass, the
              disaggregated pass and the MoE pass also run eagerly on the
              same items (graphs off, the same bodies), both runs pinned
              to the prior chain-boundary cost (``Engine._cost_pin``), and
              the streams (and the MoE router stats) must be equal. The
              scheduler: pass (1) runs unpinned and must pre-admit its two
              queued requests ("scheduler:" lines: pre-admitted rids,
              steps, chains by depth, the boundary cost, probes); a
              calibration round (8 x 192 tokens, depths 1 and 2) measures
              the boundary cost on graphs and eagerly; a chaos pass
              (``fault_plan``) on pass (1)'s items must fail requests 1 and
              3 with the reference's reasons and stream the rest as the
              clean pinned run; chunked prefill runs again with
              ``disaggregate=True`` (the mixed step and a graph-replayed
              chain in the same steps; at 16 of the 32 layers, graph and
              eager), both under the profiler (wall and device busy ms a
              step). Then the trainer: ``gpt2_medium()``
              at full depth, O2 bf16, ``loss.backward()`` and
              ``AdamW.step()`` on one fixed batch (T1 packed 12 x 1024, T2
              8 x 2048, T3 the general route; T4-T6 reach the remaining
              regimes). Each pass
              zeroes the launch counters just before it and reads them
              just after.
5. serve    — ``llama2_7b`` at full width and depth, bf16, random weights
              from a seed, prefix cache on, behind the port's HTTP front
              end (``ServingFrontend`` + ``ApiServer`` on 127.0.0.1, an
              ephemeral port): three requests one at a time (unary, SSE)
              held against a direct ``Engine.run`` of each alone; 24
              requests from 8 client threads (prompts 16-1024, half on a
              shared 256-token prefix so #3's suffix prefill runs, 4
              sampled, two weighted tenants, SSE and unary), a client that
              hangs up mid-stream (must end ``cancelled``, pages back in
              the pool), a 0 ms deadline (must fail ``deadline``);
              ``/healthz``, ``/readyz`` and a Prometheus scrape whose TTFT
              count must match; #1, #2 and #3 must launch, on their
              tensor-core bodies. Then two closed loops at concurrency 8
              (tok/s, TTFT from the tickets) and a third under the
              profiler (wall and device busy ms of the same engine steps)
              against a direct run of the same items, ``multi_step=4``
              against 1 on a pure-decode
              round, and 2-layer f32 at ``llama2_7b`` widths: concurrent
              HTTP greedy streams against a direct ``Engine.run``.
6. generate — ``GenerationMixin.generate``: GPT-2 small at full depth in
              ``bench.py``'s decode shape (B=8, 128 + 512 tokens, bf16,
              then int8 and int4 weights; #2 prefill, #15 decode, #12) and
              ``llama2_7b`` at full depth (greedy and sampled), the decode
              step replayed as a CUDA graph and each bf16 run timed again
              with the step eager (equal ids required); GPT-2 small
              on user-allocated 5-D caches (#14) and one
              ``masked_multihead_attention`` step; GPT-2 small and
              ``llama2_7b`` on ``PagedKVCache`` (#4, bf16 and int8 pages),
              each held against the same run on the plain versions; then
              2-layer full-width f32 checks: greedy streams against the
              cacheless argmax, 5-D and paged logits against the slab's.
7. greedy   — 2-layer full-width f32 models (``llama2_7b`` widths, plain
              and int8 weights; Mixtral widths): the engine's greedy
              streams, plain and in each of the three modes, against the
              argmax of the same model's cacheless forward; 12 greedy
              requests on 4 slots, pre-admitted and then disaggregated,
              each equal to the request served alone; then the train
              check: loss, gradients and three AdamW steps of 2-layer
              GPT-medium and ``llama2_7b`` widths with the kernels against
              plain attention.
8. tier     — ``llama2_7b`` widths at 16 of its 32 layers (cut to make
              room for phase 18), bf16, random weights from a seed. (a)
              The host KV tier under churn: 16 templates of 512 tokens
              (512 pages, 2 GiB) against a 256-page pool and a 512-page
              pinned slab, 32-token tails, 32 new tokens, two
              rounds whose requests arrive together; every promoted page
              is hashed on the card right after its restore and must equal
              its bytes at demotion; demotions, promotions, the worker's
              backlog, each copy direction's waves (device ms, bytes)
              beside the 64 GB/s link, round 2's TTFT tier on and off in
              turns. (b) ``integrity="audit"``: the weight baseline's
              time, weight probes, checksum waves of 1, 8 and 32 pages and
              the checksum's width invariance, tok/s audit on and off in
              turns; zero failures, nonzero weight and kv checks. (c)
              ``bit-flip-kv`` detected and contained; ``bit-flip-weight``
              quarantines the engine and ``/readyz`` over the ApiServer
              says so (the bit is put back); (d) strict: the shadow every
              4 steps on clean greedy streams, its margins against
              ``shadow_tol``; (e) the handoff: a 512-token prompt's pages
              exported from one ApiServer (``POST /v1/kv``) and imported
              into another, the payload's size, each stage's ms and the
              importer's TTFT against a fresh engine's; then the weight
              flip on int8 weights (#12's buffers). Then f32, TF32 off,
              two layers: the tier under churn, the audit with
              ``bit-flip-kv`` and a handed-off prompt each give the plain
              run's streams, greedy and sampled.
9. cluster  — multi-replica serving at ``llama2_7b`` widths bf16 (8 of
              its 32 layers in-process, cut to make room for phases 13
              and 14; the workers of (c) at full depth), prefix cache on, every kernel built before any engine
              thread or worker starts. (a) Two ``InProcReplica``s on one
              model (4 slots, 512 pages each) behind ``Router(heartbeat_s=
              0.1)``, ``hedge_ms`` and ``stall_s`` set from a warm
              replica's TTFT: 16 requests from 4 client threads (prompts
              16-512, 128 new, 4 sampled), replica 0 poisoned once 16
              tokens reached the clients; no request failure, a
              migration, the supervised restart back ready, device memory
              after it within one pool of before; the migrated streams'
              stall, the others' TTFT, the restart's seconds. (b)
              ``pools={"prefill": 1, "decode": 1}``: 8 requests on a
              shared 512-token prefix (served once on each replica first)
              with 32-token tails, 64 new, from one client: handoffs (each
              export's and adoption's ms, pages and bytes, the decode
              leg's TTFT), then the same under ``kv-handoff-corrupt:
              every=1``: fallbacks. (c) Two ``SubprocessReplica`` workers
              of ``examples/serve_llama_paged_torch.py --model llama2_7b``
              (prefix cache off), one SIGKILLed mid-stream: no failure, a
              migration, the restarted worker ready; the workers stop
              before the next part. bf16 rounds a re-prefill, the suffix
              kernel and another batch size apart from the direct run, so
              at bf16 the streams equal to it are counted and logged;
              then f32, TF32 off, two layers at ``llama2_7b`` widths, (a)
              and (b) again, and (c) with the example's f32 ``small``
              workers: there every stream must equal the direct run (the
              unkilled worker's stream). #1/#2/#3 launch counts a part.
10. draft   — draft-model speculative decoding at ``llama2_7b`` widths
              bf16, 8 of its 32 layers (cut to make room for phases 13
              and 14), on pass (1)'s pool and items, ``spec_k=4``, with (i) a
              LLaMA at TinyLlama-1.1B's published widths (22 layers, 32
              heads over 4 kv heads of 64; random weights from seed 1) and
              (ii) the target as its own draft. Each serves with the
              propose step on CUDA graphs and again eagerly (drafts and
              streams must be equal); vanilla and n-gram passes on the
              same items; tok/s, tokens a verify step, drafts proposed and
              accepted, the propose's device ms a step (graph and eager),
              the catch-up's, the drafter's own #1 and #3 launches, greedy
              streams counted equal to vanilla; ``drafter-corruption:
              every=3`` (no request fails). Then f32, TF32 off, 2 layers:
              every greedy draft stream (graph, eager, the chaos pass)
              must equal vanilla.
11. fused   — ``incubate.nn.FusedMultiTransformer`` at GPT-3 6.7B widths
              (4096, 32 heads, ffn 16384, 32 layers, bf16) and GPT-2 small
              widths: B=8, a 128-token prompt (#2) and 128 teacher-forced
              decode steps over 5-D caches (#14), the slab (#15),
              ``PagedKVCache`` (#4) and ``PagedCacheState`` (#1), the
              kinds' outputs within 5e-2 of the largest entry of each
              other; ms a decode step and launches per kind. Then f32, 2
              layers at 6.7B widths: each kind against the same layer on
              the plain versions (1e-4 of the largest entry).
12. resnet  — config 1 through ``paddle_tpu_torch.Model.fit``: (1)
              ``resnet50(num_classes=1000)``, f32, torch's default cuDNN
              settings (TF32 convolutions on, TF32 matmuls off), 1024
              random 224x224 images from a seed, batch 256, Momentum
              0.05/0.9, cross entropy and accuracy, 2 epochs of 4 steps;
              finite losses and an ``evaluate`` accuracy; images/s, ms a
              step, each step's host and device ms (CUDA events) and the
              loader's share, peak memory, FLOPs a training image and the
              share of the peak. (2) In child processes with deterministic
              algorithms (``resnet50``, batch 32, 128 images): a clean
              run, a run stopped by a real SIGTERM (committed,
              ``TrainingPreempted``) and its resume; stitched losses and
              state bitwise equal. (3) The six training and checkpoint
              fault points, each fired once in a child and recovered.
              (2) and (3) need no kernel of ``csrc/``: a full run starts
              their children beside the build and waits for them before
              the kernels phase (``_ResnetChildren``).
13. bert    — config 2 at one GPU through ``examples/train_bert_torch.py``'s
              functional step (``jit.functional_call`` + autograd +
              ``AdamW.apply_gradients_tree``) at BERT-base (12 layers,
              768 wide, 12 heads of 64, vocab 30522), f32 with TF32 off,
              seq 512, dropout 0, random weights from a seed: (a) five
              steps at batch 32 (one GPU's share of the reference's 256
              over 8 chips) on one repeated batch: losses finite and
              falling, #2 and the flash backward launched (the FMA bodies
              at f32); sequences/s, tokens/s, host and device ms a step,
              peak memory, and the flash kernels' share of one profiled
              step's device time; (b) one step's gradients with every
              encoder layer under ``fleet.recompute`` equal the plain
              step's (1e-5 of each tensor's largest entry), #2 launched
              twice as often, the peak memory lower.
14. export  — config 5: the example twin's ``TinyTransformer`` (#2 at
              head dim 16) and ``BertForMaskedLM`` at BERT-base width,
              2 of its 12 layers (batch 8, seq 512), f32, through
              ``jit.to_static``
              (``torch.compile(fullgraph=True)``), ``jit.save`` (the
              BERT with ``InputSpec([None, 512])``) -> ``jit.load`` and
              ``create_predictor(Config(prefix)).run`` (the BERT at
              batches 8 and 4): each within 1e-4 of eager's largest
              entry, #2 launched inside the compiled, the loaded and the
              predictor's programs; eager, ``to_static``, loaded and
              Predictor ms a call.
15. moe_train — MoE training at one GPU through
              ``incubate.distributed.models.moe`` at Mixtral-8x7B's expert
              widths: two blocks of ``LayerNorm(4096)`` -> ``MoELayer(8 x
              ExpertFFN(4096, 14336, "silu"), GShardGate top-2 with random
              routing)`` -> residual (1.88 B parameters), bf16 through
              ``amp.decorate(level="O2")``, AdamW with f32 masters and
              ``ClipGradForMOEByGlobalNorm(1.0)`` (the experts
              ``is_expert``), batch 4 x 1024 tokens, weights from a seed.
              First ``ragged_dot`` (#13 for the forward and dX, one matmul
              per expert for dW) against ``grouped_matmul_ref`` under
              autograd at these widths in bf16 (2e-2 of the largest
              entry) and at a quarter of them in f32 (1e-4), #13's forward
              and dX timed beside ``torch._grouped_mm`` and the bound.
              Then step 1 of the ragged and the dense path from the same
              weights and routing draw: the loss within 1e-2 and every
              gradient within 2e-2 in relative norm, #13 launched in the
              ragged forward and backward, random routing's dropped
              second choices present and put past the groups at weight
              0; then 4 ragged, 3 dense and 3 dropless steps from the same
              weights (losses finite and falling, aux finite; ms a step by
              CUDA events from step 2, tokens/s, peak memory) and #13's
              share of a profiled ragged step's device time.
16. tp      — tensor- and expert-parallel serving and config 3 at
              nranks=2, as two rank processes sharing the one card over
              gloo (CUDA tensors; every number labelled so: it is not a TP
              speed): the kernels of the path at shard shapes against
              their plain versions (#1, #3 at 16 heads, #2 on a 512-token
              wave, #13 over 4 local experts, #4, #14, #15 at 16 heads),
              then ``Engine(tp=2)`` at ``llama2_7b()`` widths (f32, 8 of
              32 layers, chunked prefill + prefix cache + n-gram spec:
              streams equal tp=None's, the ranks' command outputs hash
              alike; bf16, 32 layers: tok/s, TTFT, peak memory a rank,
              the all-reduce's share, rows equal to tp=None),
              ``Engine(ep=2)`` at Mixtral-8x7B's widths (f32 2 layers:
              streams and router stats equal ep=None's; bf16 8 layers:
              tok/s, #13's launches), ``FusedMultiTransformer`` at
              nranks=2 (GPT-3 6.7B widths, B=8, 5-D / slab /
              ``PagedKVCache``: f32 against nranks=1, bf16 ms a step) and
              ``examples/generate_gpt_tp_torch.py``'s path at GPT-2 small,
              mp=2 (greedy tokens equal mp=1's). tp=2 x ep=2 would need
              four processes on the card: the CPU tests hold it.
17. dp      — data-parallel and sharded training, as two rank processes
              sharing the one card over gloo, TF32 off: #2 and #5 at a
              rank's config 2 shape (B=16 S=512 H=12 D=64 f32) against
              their plain versions; BERT-base at dp=2 (global batch 32,
              four steps through ``fleet.distributed_model`` and
              ``fleet.distributed_optimizer(AdamW, ClipGradByGlobalNorm)``)
              against one process on the same rows, the ranks'
              parameters hashed alike after every step (sequences/s, ms a
              step, the all-reduce's share, buckets, peak memory a rank);
              ZeRO ``os`` / ``os_g`` / ``p_g_os`` at 2 of 12 layers
              against dp (memory at rest and peak a rank); ``resnet50``
              with ``SyncBatchNorm`` through ``Model.fit`` against one
              process's batch norms (step 1's update and step 2's
              buffers against one process of its arithmetic, a planted
              rank-local backward shown beyond the limit); the ``os``
              state saved by both ranks and loaded on rank 0 alone,
              bitwise (``phase_dp``).
18. pp      — pipeline parallelism and config 4
              (``examples/pretrain_gpt_hybrid_torch.py``'s path) as four
              rank processes sharing the one card over gloo (pp 2 x mp
              2, TF32 off; point-to-point sends through host buffers): #2
              and the flash backward at a rank's shape (f32, 2 x 2048, 16
              heads of 128) against their plain versions; config 4's
              widths (hidden 4096, 32 heads, vocab 50304) at 4 of 32
              layers, global batch 8 x 2048 in 4 microbatches, two steps
              of ``train_batch`` (1F1B, recompute) through
              ``fleet.distributed_model`` / ``distributed_optimizer(AdamW,
              ClipGradByGlobalNorm)``, against one process on the same
              weights and microbatches: losses equal on every rank and
              within 1e-5, parameters by the dp phase's rule, the mp
              ranks' replicated parameters hashed alike; ms a step,
              tokens/s, the point-to-point and mp shares, peak memory a
              rank, ``profiler.mfu`` (``phase_pp``).

The flash kernels run bf16 at head dims 64 and 128 on their tensor-core
bodies: the kernels, context and training passes log those kernels'
ptxas registers and spill bytes (and fail on a spill), and every bf16
pass (T1-T6, the context path, the engine's passes, ``generate``) fails
unless each of its flash launches was a tensor-core launch. The log's
``flash row`` lines set each timed flash row beside the time of the
FMA-only kernel it replaced (``FMA_BEFORE``, earlier runs of this script);
the kernel JSON line holds only this run's numbers. The verify kernel
(#3) runs bf16 at head dims 64 and 128 on its tensor-core body, with
split-K at narrow widths, and the grouped expert matmul (#13) runs its
prefill shapes on its ``wgmma`` body: the kernels phase logs both bodies'
ptxas registers and spills (a spill fails), times each beside the body it
replaced on the same inputs (``fma_ms``, ``wmma_ms``) and the merge
kernel's share of a split call; every bf16 engine pass through #3 fails
unless each verify launch was a tensor-core one, and the MoE chunked pass
unless it reached the ``wgmma`` body. The weight-only quant matmul (#12)
runs bf16 x on its tensor-core body, which sums its K splits inside the
launch, and the decode body of #1, #4, #14 and #15 cuts each live window
into chunks on the card (``decode_splits`` chunks, merged in the same
launch): the kernels phase logs both new bodies' ptxas registers and
spills (a spill fails) and times each beside the body it replaced on the
same inputs (``fma_ms``: #12's FMA body and its epilogue kernel;
``nosplit_ms``: the decode body with each window whole), logs both split
rules against a sweep of forced split counts, and every bf16
pass through #12 (the int8 and int4 engine and ``generate`` passes) fails
unless each of its launches was a tensor-core one.

The engine's ``step`` never raises on a recoverable fault: it requeues
and recomputes after a failed dispatch, and a spec step drafts nothing
when its drafter raises, so a run can come out right after a fault. Every
``Engine`` pass of every phase (direct, behind the front end, profiled)
therefore fails if its engine caught a step or drafter fault (a failed
graph capture or replay among them), and, unless it turned its graphs
off, if any of its decode chains or verify steps ran eagerly. A replay
calls no kernel wrapper: the runner adds each graph's launch counts,
recorded at its capture, on every replay, so the launch counts and the
tensor-core gates cover the replayed kernels.

Opt-in: ``--phases build,profile`` profiles one T1 training step, then
times 7B decode chains (bf16 and int8 weights), a spec verify step and a
Mixtral-width MoE decode chain, each eager and as CUDA graph replays (one
``profile row`` line each: wall, busy, idle, kernels, capture ms, pool
bytes), and a chunked mixed step, and lists the device kernels under
torch.profiler (PERF.md "Where the time goes").
``--phases build,drift`` walks one ``llama2_7b`` decode step layer by
layer with the decode kernels and their plain versions on the same inputs
and logs each layer's attention and block error. ``--phases
build,anatomy`` times #12's tensor-core body with parts of its work cut
out (the weight bytes, the dequant, the MMAs) at the decode and
spec-verify rows, to show what binds it. ``--phases build,sched`` runs
each scheduler piece against the same engine without it, in turns:
pre-admission on pass (1)'s items, the measured boundary cost against the
pinned prior on a steady decode round, ``disaggregate=True`` against the
plain mixed step. ``--phases build,loadgen`` runs the four ported
serving benches (``serving/loadgen.py``: slo, trace, failover, cluster)
at ``gpt2_small()`` bf16 and logs each returned dict; only their
correctness parts (no request failure, the failover bench's migrations)
fail it. ``--phases build,draftcause`` serves ``llama2_7b`` bf16 as its
own draft with one piece at a time on another version (the drafter's
catch-up or propose on the plain #3 or #1, every #3 on its FMA body,
every attention kernel plain, 2 and 8 layers) and logs the acceptance of
each, greedy rows apart; then profiles the TinyLlama-width draft's
propose step, graph replay and eager body (stream interval, device busy
time, largest kernels). ``--phases ncclprobe`` has two NCCL ranks on the
one card try one all-reduce (bounded to 120 s) and logs what NCCL says.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or paddle_tpu.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
PHASES = ("build", "kernels", "context", "main", "serve", "generate",
          "greedy", "tier", "cluster", "draft", "fused", "resnet", "bert",
          "export", "moe_train", "tp", "dp", "pp")
OPTIONAL_PHASES = ("profile", "drift", "anatomy", "sched", "loadgen",
                   "draftcause", "ncclprobe")


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, reps=10):
    """Median CUDA-event milliseconds of ``fn()`` after ``warmup`` calls.
    Each timed call is queued behind a ~1 ms device spin, so the host's
    time to launch it (a Python wrapper takes tens of microseconds) hides
    behind the spin and the events see the device's time alone (a call
    that waits for the device itself still counts its host time)."""
    import torch

    spin = getattr(torch.cuda, "_sleep", None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin is not None:
            spin(2_000_000)
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


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


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


def tc_ptxas(tag):
    """Log the ptxas registers and spill bytes of every tensor-core flash
    kernel (``*_tc_kernel``, from the ``-Xptxas -v`` report that the build
    keeps beside each library). Fail if one spills, if the report holds
    none, or if a library holds an FMA body for bf16 at D 64 or 128: each
    bf16 launch there must reach the tensor-core body, which is how the
    wrappers count ``tc_launches``. Returns the number of kernels read."""
    from paddle_tpu_torch.kernels import build

    n = 0
    for lib in ("flash_attention_fwd", "flash_attention_bwd"):
        name = None
        for ln in build.ptxas_report(lib).splitlines():
            m = re.search(r"\d(flash_\w+?_fma_kernel)I13__nv_bfloat16Li(\d+)E",
                          ln)
            if m and int(m.group(2)) in (64, 128):
                raise AssertionError(f"{tag}: {lib} holds {m.group(1)} for "
                                     f"bf16 at D {m.group(2)}")
            m = re.search(r"\d(flash_(?:fwd|bwd_dkv|bwd_dq)_tc_kernel)I"
                          r"(\w+?)EEv", ln)
            if m:
                args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
                name = f"{m.group(1)}<{', '.join(args)}>"
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if name and m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if name and m:
                log(f"{tag}: ptxas {name}: {m.group(1)} registers, spill "
                    f"stores {spill[0]} B, loads {spill[1]} B")
                if any(spill):
                    raise AssertionError(f"{tag}: {name} spills")
                name, n = None, n + 1
    if n == 0:
        raise AssertionError(f"{tag}: the ptxas report names no tensor-core "
                             "flash kernel")
    return n


# ------------------------------------------------------------ phase 2
_MANGLED = (("13__nv_bfloat16", "bf16"), ("S2_", "bf16"), ("f", "f32"),
            ("a", "int8"), ("NS0_9SlabPagesE", "slab pages"),
            ("NS0_14HeadMajorPagesE", "head-major pages"),
            ("NS0_12StridedCacheE", "strided cache"))


def _template_args(mangled):
    """The template arguments of a mangled kernel name, readable: integers
    (``Li128E``, ``Lb1E``) and the decode body's types and row sources."""
    out, rest = [], mangled
    while rest:
        m = re.match(r"L[ib](\d+)E", rest)
        if m:
            out.append(m.group(1))
            rest = rest[m.end():]
            continue
        for code, word in _MANGLED:
            if rest.startswith(code):
                out.append(word)
                rest = rest[len(code):]
                break
        else:
            rest = rest[1:]
    return ", ".join(out)


def body_ptxas(tag):
    """Log the ptxas registers and spill bytes of the tensor-core verify
    kernel (``verify_tc_kernel<D, BQ, int8 pages>``), the wgmma grouped
    matmul (``grouped_wgmma_kernel<BN>``), the tensor-core quant matmul
    (``quant_tc_kernel<int4, n8 tiles, vector weight, vector x>``) and the
    split decode body (``decode_kernel<q, kv, D, GC, rows>``, in each of
    its three libraries), from the ``-Xptxas -v`` report the build keeps
    beside each library: every instance of the first two, the main
    path's of the others (the quant body's vector-load instances, the
    decode body's at D 128), and a summary line for each. Fail if one
    spills or if a report names none of them. Returns the number of
    kernels read."""
    from paddle_tpu_torch.kernels import build

    n = 0
    for lib, kernel, shown in (
            ("paged_verify_attention", "verify_tc_kernel", ""),
            ("grouped_matmul", "grouped_wgmma_kernel", ""),
            ("quant_matmul", "quant_tc_kernel", ", 1, 1>"),
            ("paged_decode_attention", "decode_kernel", ", 128, "),
            ("paged_decode_attention_v1", "decode_kernel", ", 128, "),
            ("decode_attention", "decode_kernel", ", 128, ")):
        name, found, regs, spilled = None, 0, [], []
        for ln in build.ptxas_report(lib).splitlines():
            m = re.search(rf"\d{kernel}I(\w+?)EEv", ln)
            if m:
                name = f"{kernel}<{_template_args(m.group(1))}>"
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if name and m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if name and m:
                if shown in name or any(spill):
                    log(f"{tag}: ptxas [{lib}] {name}: {m.group(1)} "
                        f"registers, spill stores {spill[0]} B, loads "
                        f"{spill[1]} B")
                regs.append(int(m.group(1)))
                if any(spill):
                    spilled.append(name)
                name, found = None, found + 1
        if found == 0:
            raise AssertionError(f"{tag}: the ptxas report of {lib} names "
                                 f"no {kernel}")
        if spilled:
            raise AssertionError(f"{tag}: {lib} spills in {spilled}")
        log(f"{tag}: ptxas [{lib}] {found} {kernel} instances, "
            f"{min(regs)}-{max(regs)} registers, no spills")
        n += found
    return n


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
        lib = _gathered_sdpa(torch, q[:, None], k, v, sc, tables,
                             torch.clamp(lens.long(), max=cap)[:, None],
                             H, Hkv, D, cap)
        rec.update(
            ms=time_ms(lambda: pa.paged_slab_decode_attention(
                q, k, v, tables, lens, H, scale_pages=sc)),
            nosplit_ms=time_ms(lambda: pa._paged_slab_decode(
                q, k, v, tables, lens, H, scale_pages=sc, splits=1)),
            splits=pa.decode_splits(B, H, Hkv, cap, _sms(torch)),
            plain_ms=time_ms(lambda: pa.paged_slab_decode_attention_ref(
                q, k, v, tables, lens, scale_pages=sc), warmup=1, reps=3),
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=time_ms(lib))
        del lib
        torch.cuda.empty_cache()
    return rec


def _gathered_sdpa(torch, q, k, v, sc, tables, lim, H, Hkv, D, cap):
    """The library yardstick of the paged attention kernels: each row's
    window gathered beforehand (not timed) into contiguous K/V, GQA heads
    repeated, int8 pages dequantized, then one SDPA call with query j of
    row b masked to keys ``< lim[b, j]``. q [B, m, H, D]; returns the
    timed call."""
    B = q.shape[0]
    win = max(1, int(lim.max()))
    bt = tables.long()

    def window(pages, lanes):
        w = pages[bt].reshape(B, cap, Hkv, D)[:, :win].float()
        if sc is not None:
            w = w * sc[bt].reshape(B, cap, 128)[:, :win, lanes].float()[
                ..., None]
        w = w.to(q.dtype).transpose(1, 2)
        return w.repeat_interleave(H // Hkv, dim=1)

    kw = window(k, slice(0, Hkv))
    vw = window(v, slice(Hkv, 2 * Hkv))
    mask = (torch.arange(win, device=q.device)[None, None]
            < lim[..., None])[:, None]
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kw, vw, attn_mask=mask)


def check_flash(torch, dtype, B, S, H, D, atol, rtol, timed, Hkv=None,
                causal=True):
    """#2 against its plain version; ``Hkv`` < H gives k/v fewer heads
    (the kernel's native GQA; SDPA gets them expanded)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    Hkv = Hkv or H
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (H, Hkv, Hkv))
    got, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=causal,
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
        pairs = _causal_pairs(S, S, causal)
        flops = 4 * B * H * D * pairs
        nbytes = 2 * B * S * (H + Hkv) * D * q.element_size()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        b_ops = flops / peak * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        qt, kt, vt = (t.transpose(1, 2).repeat_interleave(H // t.shape[2],
                                                          dim=1)
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec.update(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                      causal=causal)),
            plain_ms=time_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal=causal), warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal)))
    return rec


def log_op_dispatch(torch, calls=50):
    """Host microseconds a call of #2's forward at the main path's largest
    prefill wave (bf16 B=8 S=1024 H=32 D=128, causal), under no_grad:
    ``F.flash_attention`` as the engine's prefill calls it (eager: the
    wrapper), the registered operator (what a traced program calls) and
    the wrapper called directly. Each way enqueues ``calls`` calls with no
    sync between them (the device runs behind), alternating the ways over
    three rounds; the least round of each is logged."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((8, 1024, 32, 128), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ways = {
        "F.flash_attention": lambda: F.flash_attention(q, k, v,
                                                       causal=True)[0],
        "operator": lambda: fa.flash_attention_fwd_lse_op(
            q, k, v, True, None, None, None)[0],
        "wrapper": lambda: fa.flash_attention_fwd(q, k, v, causal=True)}
    best = {}
    with torch.no_grad():
        for name, fn in ways.items():
            fn()
        for _ in range(3):
            for name, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                us = (time.perf_counter() - t0) / calls * 1e6
                best[name] = min(best.get(name, us), us)
        torch.cuda.synchronize()
    extra = best["operator"] - best["wrapper"]
    log("flash forward host cost (bf16 B=8 S=1024 H=32 D=128 causal, "
        f"{calls} calls enqueued, least of 3 rounds): "
        + ", ".join(f"{n} {us:.1f} us a call" for n, us in best.items())
        + f"; the operator adds {extra:.1f} us a call, "
        f"{32 * extra / 1e3:.3f} ms over llama2_7b's 32 layers of one "
        "prefill wave, which eager calls do not pay")
    return best


def check_verify(torch, dtype, quant, B, m, H, Hkv, D, ps, max_pages, bases,
                 atol, rtol, timed, seed=3):
    """The verify kernel against its plain twin. Bound: q in, f32 out and
    each row's min(base + m, cap) live K/V rows (plus their scales) over
    HBM; 4*H*D*sum_b sum_j min(base_b + j + 1, cap) flops over the bf16
    peak. Library: SDPA over each row's window gathered beforehand into
    contiguous K/V, with the same boolean mask (the gather is not
    timed). Timed calls also time the FMA body without split-K (the
    kernel the tensor-core body replaced) on the same inputs,
    ``fma_ms``."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    q, k, v, tables, _, sc = _decode_case(
        torch, dtype, quant, B, H, Hkv, D, ps, max_pages, [0] * B, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, m, H, D), generator=g, device="cuda").to(dtype)
    base = torch.tensor(bases, dtype=torch.int32, device="cuda")
    got = pa.paged_verify_slab_attention(q, k, v, tables, base,
                                         scale_pages=sc)
    torch.cuda.synchronize()
    want = pa.paged_verify_slab_attention_ref(q, k, v, tables, base,
                                              scale_pages=sc)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"paged verify {dtype} quant={quant} m={m}: "
                             f"max abs err {err} beyond atol={atol} "
                             f"rtol={rtol}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("paged verify produced non-finite values")
    cap = max_pages * ps
    rec = {"max_abs_err": err,
           "body": pa.verify_body(q.dtype, k.dtype, D),
           "splits": pa.verify_splits(B, m, H, Hkv, cap, torch.cuda.
                                      get_device_properties(0).
                                      multi_processor_count)}
    if not timed:
        return rec
    live = [min(b + m, cap) for b in bases]
    kv_elem = 1 if quant else k.element_size()
    nbytes = (q.numel() * q.element_size() + got.numel() * 4
              + 2 * sum(live) * Hkv * D * kv_elem
              + (sum(live) * 2 * Hkv * 2 if quant else 0)
              + tables.numel() * 4 + base.numel() * 4)
    pairs = sum(min(b + j + 1, cap) for b in bases for j in range(m))
    flops = 4 * H * D * pairs
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / BF16_FLOPS_PER_S * 1e3
    # the library yardstick: SDPA on contiguous windows gathered up front
    lim = torch.clamp(base.long()[:, None] + torch.arange(
        m, device="cuda")[None] + 1, max=cap)
    lib = _gathered_sdpa(torch, q, k, v, sc, tables, lim, H, Hkv, D, cap)
    rec.update(
        ms=time_ms(lambda: pa.paged_verify_slab_attention(
            q, k, v, tables, base, scale_pages=sc)),
        fma_ms=time_ms(lambda: pa._paged_verify(
            q, k, v, tables, base, scale_pages=sc, body="fma", splits=1)),
        plain_ms=time_ms(lambda: pa.paged_verify_slab_attention_ref(
            q, k, v, tables, base, scale_pages=sc), warmup=1, reps=3),
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=time_ms(lib))
    if rec["splits"] > 1:  # the split-K path's kernels, by name
        rec["split_ms"] = _device_ms(
            torch, lambda: pa.paged_verify_slab_attention(
                q, k, v, tables, base, scale_pages=sc))
    del lib, want
    torch.cuda.empty_cache()
    return rec


def _device_ms(torch, fn, reps=20):
    """Device milliseconds a call of ``fn`` spends in each kernel, by
    kernel name, under torch.profiler (``reps`` calls after a warm-up);
    empty when the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def check_quant(torch, dtype, int4, M, K, N, timed, seed=5):
    """Kernel #12 against ``quant_matmul_ref``. Bound: x, the int8 (or
    packed int4) weight, the f32 scales and the output over HBM; 2*M*K*N
    flops over the peak of x's type. Library: ``torch.matmul`` of x with
    the bf16 weight of the same shape. Timed bf16 calls also time the FMA
    body (the body the tensor-core one replaced, with its epilogue kernel)
    on the same inputs, ``fma_ms``."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=g, device="cuda") * 0.02
    wq, sc = weight_quantize(w, "weight_only_int4" if int4
                             else "weight_only_int8")
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    wd = "int4" if int4 else "int8"
    got = qm.quant_matmul(x, wq, sc, weight_dtype=wd)
    torch.cuda.synchronize()
    want = qm.quant_matmul_ref(x, wq, sc, weight_dtype=wd)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"quant_matmul {wd} {dtype} {M}x{K}x{N}: max "
                             f"abs err {err} beyond atol=rtol={tol}")
    rec = {"max_abs_err": err, "body": qm.quant_body(dtype, M),
           "splits": qm.split_plan(M, K, N, int4, qm.quant_body(dtype, M))[0]}
    if timed:
        nbytes = (x.numel() * x.element_size() + wq.numel() + sc.numel() * 4
                  + got.numel() * got.element_size())
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        b_ops = 2 * M * K * N / peak * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        wb = w.to(dtype)
        rec.update(
            ms=time_ms(lambda: qm.quant_matmul(x, wq, sc, weight_dtype=wd),
                       reps=20),
            plain_ms=time_ms(lambda: qm.quant_matmul_ref(
                x, wq, sc, weight_dtype=wd), warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops > b_bytes else "bytes",
            library_ms=time_ms(lambda: torch.matmul(x, wb), reps=20))
        if rec["body"] == "tensor_core":
            rec["fma_ms"] = time_ms(lambda: qm._quant_matmul(
                x, wq, sc, weight_dtype=wd, body="fma"), reps=20)
        del wb
    return rec


def quant_split_sweep(torch, counts=(1, 2, 3, 4, 5, 7, 10, 16)):
    """Log #12's tensor-core body's ms at forced K split counts beside the
    count ``split_plan`` picks (one wave of ``tc_blocks_per_sm`` blocks an
    SM), at the llama2_7b gate/up and down shapes, 8 and 40 rows, int8 and
    int4. The plan's numbers come from here."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    for M in (8, 40):
        for K, N in ((4096, 11008), (11008, 4096)):
            for int4 in (False, True):
                g = torch.Generator(device="cuda").manual_seed(5)
                wq, sc = weight_quantize(
                    torch.randn((K, N), generator=g, device="cuda") * 0.02,
                    "weight_only_int4" if int4 else "weight_only_int8")
                x = torch.randn((M, K), generator=g,
                                device="cuda").to(torch.bfloat16)
                wd = "int4" if int4 else "int8"
                plan = qm.split_plan(M, K, N, int4, "tensor_core")[0]
                ms = {n: time_ms(lambda: qm._quant_matmul(
                    x, wq, sc, weight_dtype=wd, body="tensor_core",
                    splits=n), reps=10) for n in sorted({*counts, plan})}
                best = min(ms, key=ms.get)
                log(f"quant split sweep {wd} {M}x{K}x{N}: " + " ".join(
                    f"s{n} {t:.4f}" for n, t in ms.items())
                    + f" ms; split_plan picks {plan}, fastest here {best}")


def _grouped_library(torch, lhs, rhs, gs):
    """The grouped matmul's library yardstick: ``torch._grouped_mm`` over
    the same groups where this PyTorch has it and takes these operands,
    else one ``torch.matmul`` per expert segment. Returns (name, call)."""
    ends = torch.cumsum(gs, 0).to(torch.int32)
    gm_fn = getattr(torch, "_grouped_mm", None)
    if gm_fn is not None:
        for b in (rhs, rhs.transpose(-2, -1).contiguous().transpose(-2, -1)):
            try:
                gm_fn(lhs, b, offs=ends)
                torch.cuda.synchronize()
                return "torch._grouped_mm", lambda b=b: gm_fn(lhs, b,
                                                              offs=ends)
            except Exception:  # this build or operand layout: not taken
                torch.cuda.synchronize()
    bounds = [0] + ends.tolist()

    def loop():
        for e in range(rhs.shape[0]):
            if bounds[e + 1] > bounds[e]:
                torch.matmul(lhs[bounds[e]:bounds[e + 1]], rhs[e])
    return "per-expert torch.matmul", loop


def check_grouped(torch, dtype, K, N, cap, valid, timed, seed=6):
    """Kernel #13 against ``grouped_matmul_ref`` on the capacity-padded
    layout (E groups of ``cap`` rows, ``valid`` kept rows each): dead rows
    must be exactly zero. Bound: the live rows of lhs, the weights of the
    experts with a live row and the whole output over HBM; 2 * live rows
    * K * N flops over the peak of the dtype."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    E = len(valid)
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn((E * cap, K), generator=g, device="cuda").to(dtype)
    rhs = (torch.randn((E, K, N), generator=g, device="cuda")
           * 0.02).to(dtype)
    gs = torch.full((E,), cap, dtype=torch.int32, device="cuda")
    vs = torch.tensor(valid, dtype=torch.int32, device="cuda")
    got = gm.grouped_matmul(lhs, rhs, gs, vs)
    torch.cuda.synchronize()
    want = gm.grouped_matmul_ref(lhs, rhs, gs, vs)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"grouped_matmul {dtype} K={K} N={N} C={cap}: "
                             f"max abs err {err} beyond atol=rtol={tol}")
    for e, v in enumerate(valid):
        if bool(got[e * cap + v:(e + 1) * cap].any()):
            raise AssertionError(f"grouped_matmul: expert {e}'s rows past "
                                 f"its {v} kept rows are not exactly zero")
    rec = {"max_abs_err": err,
           "body": gm.grouped_body(dtype, E * cap, K, N, E)}
    del want
    if timed:
        live = sum(valid)
        el = lhs.element_size()
        nbytes = (live * K * el + sum(v > 0 for v in valid) * K * N * el
                  + got.numel() * el + 2 * E * 4)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        b_ops = 2 * live * K * N / peak * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        lib_name, lib = _grouped_library(torch, lhs, rhs, gs)
        rec.update(
            ms=time_ms(lambda: gm.grouped_matmul(lhs, rhs, gs, vs)),
            plain_ms=time_ms(lambda: gm.grouped_matmul_ref(lhs, rhs, gs, vs),
                             warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops > b_bytes else "bytes",
            library_ms=time_ms(lib), library=lib_name)
        if rec["body"] == "wgmma":
            rec["wmma_ms"] = time_ms(lambda: gm._grouped(
                lhs, rhs, gs, vs, body="wmma"))
        del lib
    del lhs, rhs, got
    torch.cuda.empty_cache()
    return rec


def _causal_pairs(sq, sk, causal):
    """(query, key) pairs the attention computes: the live triangle when
    causal (top-left: query i sees keys j <= i), all of them when not."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + max(0, sq - sk) * sk


def _flash_library_bwd(torch, q, k, v, do, causal, scale):
    """PyTorch's own flash backward on the same inputs ([B, H, S, D]
    views), the yardstick of the backward kernel. Returns (name, call): the
    aten flash backward after one untimed forward where this PyTorch has
    it; else SDPA forward+backward, of which the caller subtracts the
    forward."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, off = fwd[:8]

        def bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, causal, seed,
                off, scale=scale)
        bwd()
        torch.cuda.synchronize()
        return "aten._scaled_dot_product_flash_attention_backward", bwd
    except (AttributeError, RuntimeError, TypeError):
        torch.cuda.synchronize()
    qs, ks, vs = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        out = sdpa(qs, ks, vs, is_causal=causal, scale=scale)
        torch.autograd.grad(out, (qs, ks, vs), dot)
    return "sdpa forward+backward minus forward", fwd_bwd


def check_flash_bwd(torch, dtype, B, Sq, Sk, H, D, timed, causal=True,
                    dlse=False, packed=False, seed=21):
    """The backward kernel against ``flash_attention_bwd_ref`` on the same
    q, k, v, out, dO and lse (the forward kernel's). ``packed``: q, k, v
    are views of one ``[B, S, 3H, D]`` QKV buffer, the output a ``[B, S,
    H, D]`` buffer and dq/dk/dv views of one dQKV, as the packed route
    lays them out. Tolerance: every gradient within 2e-2 (bf16) or 1e-4
    (f32) of its largest entry, and within CTX_NORM_TOL of the twin's in
    relative norm. Control: the kernel's dV with one live 64-key tile
    zeroed (what a skipped tile gives) must fail the relative-norm check.
    Bound: q, k, v, out, dO (and lse, dlse)
    read once and dq, dk, dv written once over HBM; 10*D flops per live
    (query, key) pair (the five products of the recompute scheme, 2.5x the
    forward's) over the dtype's peak. Library (without dlse): PyTorch's
    own flash backward (``_flash_library_bwd``; at f32, which the aten
    flash backward refuses, SDPA forward+backward minus forward)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    scale = 1.0 / D ** 0.5
    grads = None
    if packed:
        y = torch.randn((B, Sq, 3 * H, D), generator=g, device=dev).to(dtype)
        q, k, v = y[:, :, :H], y[:, :, H:2 * H], y[:, :, 2 * H:]
        dqkv = torch.empty_like(y)
        grads = (dqkv[:, :, :H], dqkv[:, :, H:2 * H], dqkv[:, :, 2 * H:])
    else:
        q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, Sk, H, D), generator=g, device=dev).to(dtype)
                for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    dl = (torch.randn((B, H, Sq), generator=g, device=dev) * 0.1 if dlse
          else None)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, dl, causal=causal,
                                 grads=grads)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, dl,
                                      causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    norm_tol = CTX_NORM_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
    tag = f"flash bwd {dtype} B={B} Sq={Sq} Sk={Sk} H={H} D={D}"
    err = rel = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"flash bwd {name}: non-finite values")
        top = max(1.0, float(b.float().abs().max()))
        e = float((a.float() - b.float()).abs().max())
        if e > tol * top:
            raise AssertionError(f"{tag} {name}: max abs err {e} beyond "
                                 f"{tol} * {top:.3g}")
        n = _rel_norm(torch, a, b)
        if n > norm_tol:
            raise AssertionError(f"{tag} {name}: relative norm err {n:.3g} "
                                 f"beyond {norm_tol}")
        err, rel = max(err, e), max(rel, n)
    # keys past the last query are dead when causal: zero a live tile
    j = (min(Sq, Sk) if causal else Sk) // 2 // 64 * 64
    dv = got[2].float().clone()
    dv[:, j:j + 64] = 0
    ctl = _rel_norm(torch, dv, want[2])
    if ctl <= norm_tol:
        raise AssertionError(f"{tag}: control (dv keys {j}..{j + 63} "
                             f"zeroed) passes at relative norm {ctl:.3g}")
    del want, dv
    rec = {"max_abs_err": err, "rel_norm": rel, "control_rel_norm": ctl}
    if dtype == torch.bfloat16:
        # the same math on f32 upcasts, with no bf16 rounding of P and dS:
        # what the bf16 kernel's gradients lose to that rounding
        want = fa.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, out, do)), lse, dl, causal=causal)
        rec["err_vs_f32"] = max(
            float((a.float() - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in zip(got, want))
        rec["rel_vs_f32"] = max(_rel_norm(torch, a, b)
                                for a, b in zip(got, want))
        del want
    torch.cuda.empty_cache()
    if timed:
        el = q.element_size()
        nbytes = (el * (2 * B * Sq * H * D + 2 * B * Sk * H * D)   # q,k,v,o
                  + el * B * Sq * H * D                              # dO
                  + el * (B * Sq * H * D + 2 * B * Sk * H * D)     # dq,dk,dv
                  + 4 * B * H * Sq * (2 if dlse else 1))           # lse
        flops = 10 * D * B * H * _causal_pairs(Sq, Sk, causal)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        b_ops = flops / peak * 1e3
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(
            ms=time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, out, do, lse, dl, causal=causal, grads=grads)),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, do, lse, dl, causal=causal), warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
            library_ms=None, library=None)
        torch.cuda.empty_cache()
        if not dlse:
            name, lib = _flash_library_bwd(torch, q, k, v, do, causal, scale)
            lib_ms = time_ms(lib)
            if name.startswith("sdpa"):
                sdpa = torch.nn.functional.scaled_dot_product_attention
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms -= time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                               scale=scale))
            rec.update(library_ms=lib_ms, library=name)
            del lib
    del q, k, v, out, do, lse, got
    torch.cuda.empty_cache()
    return rec


def check_packed_fwd(torch, B, S, H, D, timed, seed=22):
    """#2's forward kernel on the packed route's layout (q, k, v strided
    views of one ``[B, S, 3H, D]`` buffer, the output written into a
    ``[B, S, H, D]`` buffer) against ``flash_attention_ref``, bf16, atol =
    rtol = 2e-2. Bound: q, k, v in and out over HBM; 4*D flops per live
    pair over the bf16 peak. Library: causal SDPA on contiguous [B, H, S,
    D] copies made beforehand."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn((B, S, 3 * H, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    q, k, v = y[:, :, :H], y[:, :, H:2 * H], y[:, :, 2 * H:]
    o = torch.empty((B, S, H, D), dtype=y.dtype, device="cuda")
    _, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, out=o)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    err = float((o.float() - want.float()).abs().max())
    if not torch.allclose(o.float(), want.float(), atol=2e-2, rtol=2e-2):
        raise AssertionError(f"packed forward S={S}: max abs err {err}")
    lerr = float((lse - want_lse).abs().max())
    if lerr > 1e-3:
        raise AssertionError(f"packed forward S={S}: lse max abs err {lerr}")
    del want, want_lse
    torch.cuda.empty_cache()
    rec = {"max_abs_err": err}
    if timed:
        b_ops = 4 * D * B * H * _causal_pairs(S, S, True) / \
            BF16_FLOPS_PER_S * 1e3
        b_bytes = 4 * B * S * H * D * 2 / HBM_BYTES_PER_S * 1e3
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec.update(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, out=o)),
            plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v),
                             warmup=1, reps=3),
            bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)))
        del qt, kt, vt
    del y, o, lse
    torch.cuda.empty_cache()
    return rec


def _decode_record(torch, tag, got, want, dtype):
    """The decode kernels' tolerance against their plain versions: f32
    within 2e-5 absolute (the reference's own kernel-vs-twin bound), bf16
    within one bf16 ulp of the output's largest entry (both round one f32
    result)."""
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        lim = 2e-5
    else:
        top = float(want.float().abs().max())
        lim = 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite values")
    if err > lim:
        raise AssertionError(f"{tag}: max abs err {err} beyond {lim}")
    return {"max_abs_err": err, "tolerance": lim}


def _decode_bound(q, live, Hkv, D, kv_elem, scale_bytes):
    """(bound ms, bound_by) of a decode over ``live`` K/V rows: q in, the
    output out, each live row of K and V (and its scales) read once, over
    HBM; 4 * H * D flops a live row over the bf16 peak."""
    H = q.shape[1]
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * Hkv * D * kv_elem
              + live * scale_bytes + 4 * q.shape[0])
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * live * H * D / BF16_FLOPS_PER_S * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def _window_sdpa(torch, q, k, v, lens):
    """The decode kernels' library yardstick: one SDPA call of q [B, H, D]
    over each row's live window of contiguous k/v [B, Hkv, W, D] (GQA heads
    repeated, both made beforehand, not timed), masked at ``lens``."""
    H, Hkv = q.shape[1], k.shape[1]
    win = int(lens.max())
    kw, vw = (t[:, :, :win].repeat_interleave(H // Hkv, dim=1)
              for t in (k, v))
    mask = (torch.arange(win, device=q.device)[None]
            < lens.long()[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q[:, :, None]
    return lambda: sdpa(qt, kw, vw, attn_mask=mask)


def check_contig_decode(torch, dtype, slab, B, H, Hkv, D, S, lengths, timed,
                        seed=31):
    """#15 (``slab``: the kv slab [2, B, S, Hkv*D]) or #14 (k/v caches
    [B, Hkv, S, D], the halves of one [2, B, Hkv, S, D]) against
    ``decode_attention_ref`` on the same rows. Library: SDPA over each
    row's live window."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = torch.randn((2, B, Hkv, S, D), generator=g,
                        device="cuda").to(dtype)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if slab:
        kv = cache.transpose(2, 3).reshape(2, B, S, Hkv * D).contiguous()
        del cache
        k, v = da._slab_views(kv, D)

        def run():
            return da.decode_attention_slab(q, kv, lens)
    else:
        k, v = cache[0], cache[1]

        def run():
            return da.decode_attention(q, k, v, lens)

    def nosplit():  # the same launch, each window left whole
        return da._launch(q, k, v, lens, 1.0 / math.sqrt(D),
                          da.decode_attention_slab if slab
                          else da.decode_attention, splits=1)

    def plain():
        return da.decode_attention_ref(q, k, v, lens)

    got = run()
    torch.cuda.synchronize()
    rec = _decode_record(torch, f"decode {'slab' if slab else '5-D'}", got,
                         plain(), dtype)
    if timed:
        live = sum(min(max(n, 0), S) for n in lengths)
        bound, by = _decode_bound(q, live, Hkv, D, q.element_size(), 0)
        lib = _window_sdpa(torch, q, k.contiguous(), v.contiguous(), lens)
        rec.update(ms=time_ms(run), nosplit_ms=time_ms(nosplit),
                   splits=pa.decode_splits(B, H, Hkv, S, _sms(torch)),
                   plain_ms=time_ms(plain, warmup=1, reps=3),
                   bound_ms=bound, bound_by=by, library_ms=time_ms(lib))
        del lib
    del q, k, v, got
    torch.cuda.empty_cache()
    return rec


def check_v1_decode(torch, dtype, quant, B, H, Hkv, D, ps, max_pages,
                    lengths, timed, seed=32):
    """#4 on head-major pages [Hkv, P, ps, D] (int8 with f32 per-row scales
    [Hkv, P, ps]) against ``paged_decode_attention_ref``. Library: SDPA
    over each row's window gathered (and dequantized) beforehand."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    P = 1 + B * max_pages
    k = torch.randn((Hkv, P, ps, D), generator=g, device="cuda")
    v = torch.randn((Hkv, P, ps, D), generator=g, device="cuda")
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = pa.quantize_rows_int8(k), pa.quantize_rows_int8(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    tables = perm[:B * max_pages].view(B, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)

    def run():
        return pa.paged_decode_attention(q, k, v, tables, lens, k_scales=ks,
                                         v_scales=vs)

    def nosplit():  # the same launch, each window left whole
        return pa._paged_decode(q, k, v, tables, lens, k_scales=ks,
                                v_scales=vs, splits=1)

    def plain():
        return pa.paged_decode_attention_ref(q, k, v, tables, lens,
                                             k_scales=ks, v_scales=vs)

    got = run()
    torch.cuda.synchronize()
    rec = _decode_record(torch, f"paged v1 {dtype} quant={quant}", got,
                         plain(), dtype)
    if timed:
        cap = max_pages * ps
        live = sum(min(max(n, 0), cap) for n in lengths)
        bound, by = _decode_bound(q, live, Hkv, D, 1 if quant else
                                  k.element_size(), 8 if quant else 0)
        bt = tables.long()

        def window(pages, sc):
            w = pages[:, bt].float()
            if sc is not None:
                w = w * sc[:, bt][..., None]
            return w.transpose(0, 1).reshape(B, Hkv, cap, D).to(dtype)

        lib = _window_sdpa(torch, q, window(k, ks), window(v, vs), lens)
        rec.update(ms=time_ms(run), nosplit_ms=time_ms(nosplit),
                   splits=pa.decode_splits(B, H, Hkv, cap, _sms(torch)),
                   plain_ms=time_ms(plain, warmup=1, reps=3),
                   bound_ms=bound, bound_by=by, library_ms=time_ms(lib))
        del lib
    del q, k, v, got
    torch.cuda.empty_cache()
    return rec


def check_decode_slice(torch):
    """#14, #15 and #4 at the generate phase's shapes: GPT-2 small (B=8,
    12 heads of 64, S=640, lengths ragged from 129 to 640), ``llama2_7b``
    (32 heads of 128, S=1152), GQA at Mixtral-8x7B widths (32 over 8 kv
    heads), #4 at ``llama2_7b`` widths with 16-row pages (bf16 and int8),
    bf16 timed; f32 and an idle row checked. Returns the rows of #4, #14
    and #15 (GPT-2 small for #14 and #15, ``llama2_7b`` for #4)."""
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    log("kernel decode_attention (#14 on [B, Hkv, S, D], #15 on the slab) "
        "and paged_decode_attention_v1 (#4): f32 within 2e-5, bf16 within "
        "one bf16 ulp of the output's largest entry; library_ms is SDPA "
        "over each row's live window (gathered beforehand for #4)")
    gpt_lens = [129, 200, 257, 320, 400, 511, 600, 640]
    big_lens = [129, 300, 511, 640, 777, 900, 1024, 1152]
    for tag, H, Hkv, D, S, lens in (
            ("GPT-2 small", 12, 12, 64, 640, gpt_lens),
            ("llama2_7b", 32, 32, 128, 1152, big_lens),
            ("GQA 32/8", 32, 8, 128, 1152, big_lens)):
        for slab in (True, False):
            r = check_contig_decode(torch, bf16, slab, 8, H, Hkv, D, S, lens,
                                    timed=True)
            name = "decode_attention_slab" if slab else "decode_attention"
            log(_row(f"{name} bf16 {tag} B=8 H={H} Hkv={Hkv} D={D} S={S} "
                     f"lengths={lens}", r))
            if tag == "GPT-2 small":
                res[name] = r
    for slab in (True, False):
        for H, Hkv, D in ((12, 12, 64), (32, 4, 128)):
            r = check_contig_decode(torch, f32, slab, 3, H, Hkv, D, 300,
                                    [0, 1, 300], timed=False)
            log(_row(f"{'decode_attention_slab' if slab else 'decode_attention'}"
                     f" f32 H={H} Hkv={Hkv} D={D} lengths [0, 1, 300]", r))
    for tag, H, Hkv, D in (("llama2_7b", 32, 32, 128), ("GQA 32/8", 32, 8,
                                                         128)):
        for quant in (False, True):
            r = check_v1_decode(torch, bf16, quant, 8, H, Hkv, D, 16, 72,
                                big_lens, timed=True)
            log(_row(f"paged_decode_attention_v1 {'int8' if quant else 'bf16'}"
                     f" pages, {tag} B=8 ps=16 lengths={big_lens}", r))
            if tag == "llama2_7b" and not quant:
                res["paged_decode_attention_v1"] = r
    r = check_v1_decode(torch, bf16, False, 8, 12, 12, 64, 16, 40, gpt_lens,
                        timed=True)
    log(_row(f"paged_decode_attention_v1 bf16 pages, GPT-2 small ps=16 "
             f"lengths={gpt_lens}", r))
    for quant in (False, True):
        r = check_v1_decode(torch, f32, quant, 3, 32, 8, 128, 16, 8,
                            [0, 5, 200], timed=False)
        log(_row(f"paged_decode_attention_v1 f32 {'int8' if quant else 'f32'}"
                 " pages, GQA 32/8 lengths [0, 5, 200]", r))
    return res


def decode_split_sweep(torch, counts=(1, 2, 3, 4, 6, 8, 12, 16)):
    """Log the decode body's ms at each forced chunk count beside the count
    ``decode_splits`` picks, at the main path's shapes: #1 at the ragged
    lengths (bf16, int8 pages, GQA 32/8; capacity 4096), #15 and #4 at
    the generate phase's (``llama2_7b`` S=1152, GQA 32/8, GPT-2 small
    S=640). The rule's numbers come from here."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    bf16 = torch.bfloat16
    ragged = [0, 1, 17, 300, 1000, 2049, 3333, 4096]
    big = [129, 300, 511, 640, 777, 900, 1024, 1152]
    gpt = [129, 200, 257, 320, 400, 511, 600, 640]
    cases = []
    for tag, Hkv, quant in (("bf16", 32, False), ("int8 pages", 32, True),
                            ("GQA 32/8", 8, False)):
        q, k, v, tables, lens, sc = _decode_case(
            torch, bf16, quant, 8, 32, Hkv, 128, 16, 256, ragged, 1)
        cases.append((f"#1 {tag} H=32 cap 4096 lengths={ragged}", 32, Hkv,
                      4096, lambda n, a=(q, k, v, tables, lens, sc):
                      pa._paged_slab_decode(*a[:5], scale_pages=a[5],
                                            splits=n)))
    for tag, H, Hkv, D, S, lens_ in (
            ("llama2_7b", 32, 32, 128, 1152, big),
            ("GQA 32/8", 32, 8, 128, 1152, big),
            ("GPT-2 small", 12, 12, 64, 640, gpt)):
        g = torch.Generator(device="cuda").manual_seed(31)
        kv = torch.randn((2, 8, S, Hkv * D), generator=g,
                         device="cuda").to(bf16)
        q = torch.randn((8, H, D), generator=g, device="cuda").to(bf16)
        lens = torch.tensor(lens_, dtype=torch.int32, device="cuda")
        k, v = da._slab_views(kv, D)
        cases.append((f"#15 {tag} cap {S} lengths={lens_}", H, Hkv, S,
                      lambda n, a=(q, k, v, lens, D): da._launch(
                          *a[:4], a[4] ** -0.5, da.decode_attention_slab,
                          splits=n)))
    g = torch.Generator(device="cuda").manual_seed(32)
    kp, vp = (torch.randn((32, 1 + 8 * 72, 16, 128), generator=g,
                          device="cuda").to(bf16) for _ in range(2))
    tables = (torch.randperm(8 * 72, generator=g, device="cuda") + 1).view(
        8, 72).to(torch.int32)
    q = torch.randn((8, 32, 128), generator=g, device="cuda").to(bf16)
    lens = torch.tensor(big, dtype=torch.int32, device="cuda")
    cases.append((f"#4 llama2_7b cap 1152 lengths={big}", 32, 32, 1152,
                  lambda n: pa._paged_decode(q, kp, vp, tables, lens,
                                             splits=n)))
    for tag, H, Hkv, cap, fn in cases:
        rule = pa.decode_splits(8, H, Hkv, cap, _sms(torch))
        ms = {n: time_ms(lambda: fn(n), reps=10) for n in counts}
        best = min(ms, key=ms.get)
        log(f"decode split sweep {tag}: " + " ".join(
            f"s{n} {t:.4f}" for n, t in ms.items())
            + f" ms; decode_splits picks {rule}, fastest here {best}")
    del cases, kp, vp
    torch.cuda.empty_cache()


def _row(tag, r):
    extra = ""
    if "ms" in r:
        lib = r["library_ms"]
        extra = (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} "
                 f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']}) "
                 f"library_ms="
                 + ("none" if lib is None else f"{lib:.4f}"))
    for old in ("fma_ms", "nosplit_ms"):  # the body this one replaced
        if old in r:
            extra += (f" {old}={r[old]:.4f} ({old[:-3]}/ms "
                      f"{r[old] / r['ms']:.2f}x)")
    if "splits" in r and "ms" in r:
        extra += f" splits={r['splits']}"
    if "rel_norm" in r:
        extra += (f" rel_norm={r['rel_norm']:.3g} control_rel_norm="
                  f"{r['control_rel_norm']:.3g}")
    if "err_vs_f32" in r:
        extra += (f" err_vs_f32={r['err_vs_f32']:.3g} (of the largest "
                  f"entry) rel_vs_f32={r['rel_vs_f32']:.3g}")
    return f"kernel {tag}: max_abs_err={r['max_abs_err']:.3g}{extra}"


def _verify_row(tag, r):
    """A timed verify line: the body, its chunks, the FMA body's time of
    the same run, and the merge kernel's share where split-K ran."""
    line = _row(f"paged_verify_attention {tag}", r) + f" body={r['body']}"
    if "split_ms" in r:
        ms = r["split_ms"]
        merge = sum(v for k, v in ms.items() if "merge" in k)
        if not ms:  # torch.profiler may record no device event for a call
            line += "; the merge kernel's share not measured (no profile)"
        else:
            line += (f"; profiled {sum(ms.values()):.4f} ms a call, the "
                     f"merge kernel {merge:.4f} ms "
                     f"({merge / sum(ms.values()):.1%})")
    return line


def phase_kernels():
    import torch

    tc_ptxas("kernels")
    body_ptxas("kernels")
    bf16, f32 = torch.bfloat16, torch.float32
    # llama2_7b decode: B=8 slots, H=Hkv=32, D=128, page 16, 256 pages per
    # sequence (max_position 4096); ragged lengths with 0 and the cap
    lengths = [0, 1, 17, 300, 1000, 2049, 3333, 4096]
    dec = dict(B=8, H=32, Hkv=32, D=128, ps=16, max_pages=256,
               lengths=lengths)
    results = {}
    tol = dict(atol=2e-2, rtol=2e-2)
    log("kernel paged_decode_attention: each window cut into `splits` "
        "chunks on the card (decode_splits); nosplit_ms is the same body "
        "with each window whole (splits=1), the kernel the split replaced, "
        "on the same inputs in this run; library_ms is SDPA over windows "
        "gathered beforehand")
    r = check_decode(torch, bf16, False, timed=True, **dec, **tol)
    log(_row(f"paged_decode_attention bf16 B=8 H=32 D=128 ps=16 "
             f"lengths={lengths} (atol 2e-2 rtol 2e-2)", r))
    results["paged_decode_attention"] = r
    r8 = check_decode(torch, bf16, True, timed=True, **dec, **tol)
    log(_row("paged_decode_attention int8 pages, same shapes (atol 2e-2 "
             "rtol 2e-2)", r8))
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
    # config 5's TinyTransformer: 4 heads of 16, non-causal, f32 (the FMA
    # body at D = 16), at the example's [2, 16] and at a ragged S
    for B, S in ((2, 16), (2, 1000)):
        r16 = check_flash(torch, f32, B, S, 4, 16, atol=1e-4, rtol=1e-4,
                          timed=False, causal=False)
        log(f"kernel flash_attention_fwd f32 B={B} S={S} H=4 D=16 "
            f"non-causal: max_abs_err={r16['max_abs_err']:.3g} (atol 1e-4 "
            f"rtol 1e-4)")
    # BERT-base (config 2, the bert phase): 12 heads of 64, S=512, batch
    # 32, non-causal, f32 (the FMA body)
    rb = check_flash(torch, f32, 32, 512, 12, 64, atol=1e-4, rtol=1e-4,
                     timed=True, causal=False)
    log(_row("flash_attention_fwd f32 B=32 S=512 H=12 D=64 non-causal "
             "(BERT-base; atol 1e-4 rtol 1e-4; library sdpa)", rb))
    log_op_dispatch(torch)
    # llama2_7b verify shapes: spec verify (m = spec_k + 1; the last base
    # overshoots the capacity), a chunked-prefill step (m = prefill_chunk)
    # and a suffix-prefill wave (m = the pow2 bucket of the suffixes); the
    # same at Mixtral-8x7B's GQA (32 q heads over 8 kv heads); bf16 and
    # int8 pages
    ver = dict(B=8, H=32, Hkv=32, D=128, ps=16, max_pages=256)
    gqa = dict(B=8, H=32, Hkv=8, D=128, ps=16, max_pages=256)
    cases = [("spec verify", 5, [0, 1, 17, 300, 1000, 2049, 3333, 4094]),
             ("chunked prefill", 256, [0, 0, 256, 512, 1000, 2048, 3000,
                                       3840]),
             ("suffix prefill", 512, [0, 512, 512, 1024, 1024, 2048, 0,
                                      3072])]
    log("kernel paged_verify_attention: library_ms is SDPA over windows "
        "gathered beforehand into contiguous K/V with the same mask (the "
        "gather is not timed); fma_ms is the FMA body without split-K, the "
        "kernel the tensor-core body replaced, on the same inputs in this "
        "run")
    for heads, kw in (("H=32", ver), ("GQA 32/8", gqa)):
        for tag, m, bases in cases:
            for quant in (False, True):
                rv = check_verify(torch, bf16, quant, m=m, bases=bases,
                                  timed=True, **kw, **tol)
                log(_verify_row(f"{heads} {'int8' if quant else 'bf16'} "
                                f"pages {tag} B=8 m={m} D=128 ps=16 "
                                f"bases={bases}", rv))
                if (heads, m, quant) == ("H=32", 5, False):
                    results["paged_verify_attention"] = rv
    rv32 = check_verify(torch, f32, False, B=2, m=7, H=32, Hkv=32, D=128,
                        ps=16, max_pages=16, bases=[0, 200], atol=1e-4,
                        rtol=1e-4, timed=False)
    log(f"kernel paged_verify_attention f32 B=2 m=7 (body "
        f"{rv32['body']}): max_abs_err={rv32['max_abs_err']:.3g} (atol 1e-4 "
        f"rtol 1e-4)")

    # GQA at Mixtral-8x7B widths, the same lengths as above: #1 and #2
    # with native GQA k/v
    r = check_decode(torch, bf16, False, lengths=lengths, timed=True,
                     **gqa, **tol)
    log(_row(f"paged_decode_attention GQA 32/8 bf16 lengths={lengths}", r))
    # the draft pass's draft at TinyLlama-1.1B widths: 32 q heads over 4 kv
    # heads of 64 (a GQA group of 8), max_position 2048 (128 pages of 16):
    # #1 at the propose step's ragged lengths, #3 at the verify rows (m =
    # spec_k + 1); bf16 and f32
    tiny = dict(B=8, H=32, Hkv=4, D=64, ps=16, max_pages=128)
    tl_lengths = [0, 1, 17, 300, 700, 1024, 1500, 2048]
    r = check_decode(torch, bf16, False, lengths=tl_lengths, timed=True,
                     **tiny, **tol)
    log(_row(f"paged_decode_attention GQA 32/4 D=64 bf16 B=8 ps=16 "
             f"lengths={tl_lengths} (atol 2e-2 rtol 2e-2)", r))
    r = check_decode(torch, f32, False, lengths=tl_lengths, timed=False,
                     atol=1e-4, rtol=1e-4, **tiny)
    log(f"kernel paged_decode_attention GQA 32/4 D=64 f32: max_abs_err="
        f"{r['max_abs_err']:.3g} (atol 1e-4 rtol 1e-4)")
    # the drafter's catch-up on admission writes each new request's whole
    # prompt in one verify-mode wave: m = the pow2 bucket of the wave's
    # longest prompt, 1024 for the draft pass's 700-1024-token prompts.
    # Bases all 0 (an admission wave of new requests) and ragged (rows
    # behind a cached draft prefix), at the TinyLlama draft's widths and at
    # llama2_7b's (the target drafting for itself); bf16 and f32
    catch_up = [("spec verify", tiny, "GQA 32/4 D=64", 5,
                 [0, 1, 17, 300, 700, 1024, 1500, 2042])]
    for kw, heads in ((tiny, "GQA 32/4 D=64"), (ver, "H=32 D=128")):
        catch_up += [("catch-up", kw, heads, 1024, [0] * 8),
                     ("catch-up", kw, heads, 1024,
                      [0, 0, 0, 16, 128, 304, 512, 1024])]
    for tag, kw, heads, m, bases in catch_up:
        rv = check_verify(torch, bf16, False, m=m, bases=bases, timed=True,
                          **kw, **tol)
        log(_verify_row(f"{heads} bf16 pages {tag} B=8 m={m} ps=16 "
                        f"bases={bases}", rv))
        rv = check_verify(torch, f32, False, m=m, bases=bases, timed=False,
                          atol=1e-4, rtol=1e-4, **kw)
        log(f"kernel paged_verify_attention {heads} f32 {tag} m={m} "
            f"bases={bases} (body {rv['body']}): max_abs_err="
            f"{rv['max_abs_err']:.3g} (atol 1e-4 rtol 1e-4)")
    decode_split_sweep(torch)
    rg = check_flash(torch, bf16, 8, 1024, 32, 128, timed=True, Hkv=8, **tol)
    log(_row("flash_attention_fwd GQA 32/8 bf16 B=8 S=1024 (k/v not "
             "expanded)", rg))

    # #12 at the llama2_7b decode GEMMs (8 slots; 40 rows = 8 spec-verify
    # rows of 5), int8 and int4, bf16 timed and f32 checked; 256 rows (the
    # routing limit) and an N that is no multiple of the 128-column tile
    log("kernel quant_matmul: bf16 x on the tensor-core body (its K splits "
        "summed inside the launch), f32 on the FMA body; fma_ms is the FMA "
        "body and its epilogue kernel, which the tensor-core body replaced, "
        "on the same inputs in this run; library_ms is torch.matmul of x "
        "with the bf16 weight of the same shape")
    for M in (8, 40):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096),
                     (4096, 32000)):
            for int4 in (False, True):
                r = check_quant(torch, bf16, int4, M, K, N, timed=True)
                log(_row(f"quant_matmul {'int4' if int4 else 'int8'} bf16 "
                         f"{M}x{K}x{N} (atol 2e-2 rtol 2e-2)", r))
                if (M, K, N, int4) == (8, 4096, 11008, False):
                    results["quant_matmul"] = r
                rf = check_quant(torch, f32, int4, M, K, N, timed=False)
                log(_row(f"quant_matmul {'int4' if int4 else 'int8'} f32 "
                         f"{M}x{K}x{N} (atol 1e-4 rtol 1e-4)", rf))
    quant_split_sweep(torch)
    for M, K, N in ((256, 4096, 4096), (8, 4096, 1000), (5, 1030, 129)):
        for int4 in (False, True):
            for dt in (bf16, f32):
                r = check_quant(torch, dt, int4, M, K, N, timed=False)
                log(_row(f"quant_matmul {'int4' if int4 else 'int8'} {dt} "
                         f"{M}x{K}x{N}", r))

    # #13 at Mixtral-8x7B widths: 8 experts, gate/up 4096x14336 and down
    # 14336x4096; decode C = ceil(1.25*2*8/8) = 3 rows an expert, a
    # 4096-token prefill wave C = 1280; uneven kept counts with zeros
    dec_valid = [3, 1, 0, 2, 3, 3, 0, 1]
    pre_valid = [1280, 1000, 0, 1200, 900, 1280, 1100, 1000]
    log("kernel grouped_matmul: Mixtral-8x7B widths, E=8; bound counts the "
        "live rows and the weights of experts with a live row")
    for K, N in ((4096, 14336), (14336, 4096)):
        for cap, valid in ((3, dec_valid), (1280, pre_valid)):
            r = check_grouped(torch, bf16, K, N, cap, valid, timed=True)
            old = (f" wmma_ms={r['wmma_ms']:.4f} (the WMMA body, "
                   f"{r['wmma_ms'] / r['ms']:.1f}x)" if "wmma_ms" in r
                   else "")
            log(_row(f"grouped_matmul bf16 K={K} N={N} C={cap} "
                     f"valid={valid} (atol 2e-2 rtol 2e-2)", r)
                + f" library={r['library']} body={r['body']}{old}")
            if (K, N, cap) == (4096, 14336, 3):
                results["grouped_matmul"] = r
        r = check_grouped(torch, f32, K, N, 3, dec_valid, timed=False)
        log(_row(f"grouped_matmul f32 K={K} N={N} C=3 (atol 1e-4 rtol "
                 "1e-4)", r))
    r = check_grouped(torch, f32, 4096, 1024, 256, [256, 0, 100, 255, 1, 64,
                                                    200, 3], timed=False)
    log(_row("grouped_matmul f32 K=4096 N=1024 C=256 (atol 1e-4 rtol "
             "1e-4)", r))
    results.update(check_training_kernels(torch))
    results.update(check_decode_slice(torch))
    return results


def check_training_kernels(torch):
    """The training path's attention at GPT-medium widths (16 heads of 64):
    the backward kernel on the general layout (#5's regime B=12 S=1024,
    #6's B=8 S=2048, D=128 at 32 heads, sq != sk, an lse cotangent, f32)
    and on the packed views (#11 S=1024, #10 S=2048 and S=8192), and #2's
    forward on the packed views at #7's, #9's and #8's sequence lengths.
    Returns the rows of TPU kernels #5-#11."""
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    log("kernel flash_attention_bwd: every gradient within 2e-2 (bf16) or "
        "1e-4 (f32) of its largest entry; library_ms is PyTorch's own flash "
        "backward (the aten op where this PyTorch exposes it, else SDPA "
        "forward+backward minus forward, named per row)")
    for row, B, S, H, D in (("flash_attention_bwd_fused", 12, 1024, 16, 64),
                            ("flash_attention_bwd_split", 8, 2048, 16, 64),
                            (None, 2, 2048, 32, 128)):
        r = check_flash_bwd(torch, bf16, B, S, S, H, D, timed=True)
        log(_row(f"flash_attention_bwd general bf16 B={B} S={S} H={H} D={D} "
                 "causal", r) + f" library={r['library']}")
        if row:
            res[row] = r
    for B, Sq, Sk, causal, dl in ((4, 512, 1024, True, False),
                                  (4, 1024, 512, False, False),
                                  (4, 1000, 1000, True, True)):
        r = check_flash_bwd(torch, bf16, B, Sq, Sk, 16, 64, timed=False,
                            causal=causal, dlse=dl)
        log(_row(f"flash_attention_bwd general bf16 B={B} Sq={Sq} Sk={Sk} "
                 f"causal={causal} dlse={dl}", r))
    for D in (64, 128, 256):
        r = check_flash_bwd(torch, f32, 1, 300, 300, 4, D, timed=False,
                            dlse=True)
        log(_row(f"flash_attention_bwd general f32 S=300 H=4 D={D} dlse",
                 r))
    # BERT-base's backward (the bert phase): f32, non-causal, no lse
    # cotangent
    r = check_flash_bwd(torch, f32, 32, 512, 512, 12, 64, timed=True,
                        causal=False)
    log(_row("flash_attention_bwd general f32 B=32 S=512 H=12 D=64 "
             "non-causal (BERT-base)", r) + f" library={r['library']}")
    for row, B, S in (("causal_flash_bwd", 12, 1024),
                      ("causal_flash_bwd_tiled", 8, 2048),
                      (None, 1, 8192)):
        r = check_flash_bwd(torch, bf16, B, S, S, 16, 64, timed=True,
                            packed=True)
        log(_row(f"flash_attention_bwd packed views bf16 B={B} S={S} H=16 "
                 "D=64", r) + f" library={r['library']}")
        if row:
            res[row] = r
    for row, B, S in (("causal_flash_fwd", 24, 512),
                      ("causal_flash_fwd_row", 8, 2048),
                      ("causal_flash_fwd_tiled", 1, 8192)):
        r = check_packed_fwd(torch, B, S, 16, 64, timed=True)
        log(_row(f"flash_attention_fwd packed views bf16 B={B} S={S} H=16 "
                 "D=64 (atol 2e-2 rtol 2e-2; library causal sdpa)", r))
        res[row] = r
    return res


# ------------------------------------------------------------ context phase
def _zigzag_positions(torch, S, world):
    """Rank r's slice of a ``world``-rank zig-zag layout of S tokens: the
    ``[world, S / world]`` int32 positions on the card."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        zigzag_indices)

    return torch.from_numpy(zigzag_indices(S, world)).cuda().view(world, -1)


def _live_pos_pairs(torch, qp, kp):
    """(query, key) pairs a position-masked call computes: q_pos >= kv_pos."""
    ks = torch.sort(kp).values
    return int(torch.searchsorted(ks, qp, right=True).sum())


def _pos_mask_sdpa(torch, q, k, v, qp, kp, scale):
    """The library yardstick of the position forms: one SDPA call on [B, H,
    S, D] views with the boolean position mask as ``attn_mask`` (it gives
    NaN on rows that see no key, so only its time is used)."""
    mask = qp[:, None] >= kp[None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale)


# the context phase's tolerances: entry by entry atol = rtol = TOL, and the
# relative error over the whole tensor, ||got - want|| / ||want||, within
# NORM_TOL (which a fault confined to some rows cannot hide under)
def _rel_norm(torch, got, want):
    """||got - want|| / ||want|| in f32 (0 when both are 0)."""
    g, w = got.float(), want.float()
    diff = float(torch.linalg.vector_norm(g - w))
    return diff / max(float(torch.linalg.vector_norm(w)), 1e-30)


CTX_TOL = {"bf16": 2e-2, "f32": 1e-4}
CTX_NORM_TOL = {"bf16": 1e-2, "f32": 1e-4}


def _close_check(tag, got, want, dtype):
    """Fail unless ``got`` is finite, within atol = rtol = CTX_TOL of
    ``want`` entry by entry, and within CTX_NORM_TOL of it in relative
    Frobenius norm; return (max abs err, relative norm err)."""
    import torch

    key = "bf16" if dtype == torch.bfloat16 else "f32"
    tol, norm_tol = CTX_TOL[key], CTX_NORM_TOL[key]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{tag}: non-finite values")
    diff = (g - w).abs()
    over = diff - tol * w.abs()
    if bool((over > tol).any()):
        i = int(torch.argmax(over.flatten()))
        raise AssertionError(
            f"{tag}: {int((over > tol).sum())} entries beyond atol=rtol="
            f"{tol}; worst got {float(g.flatten()[i]):.6g} want "
            f"{float(w.flatten()[i]):.6g}")
    rel = _rel_norm(torch, g, w)
    if rel > norm_tol:
        raise AssertionError(f"{tag}: relative norm err {rel:.3g} beyond "
                             f"{norm_tol}")
    return float(diff.max()), rel


def _plain_attention(torch, q, k, v, do, heads=4, **kw):
    """``(out, lse, dq, dk, dv)`` of the plain twins on ``[B, S, H, D]``:
    ``flash_attention_ref``, then ``flash_attention_bwd_ref`` on the twin's
    own out and lse with ``do``, ``heads`` heads at a time so that the f32
    logits fit (4 GiB a group at S=16384). ``kw``: ``causal`` or the
    positions."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    parts = [[] for _ in range(5)]
    for h in range(0, q.shape[2], heads):
        a = [t[:, :, h:h + heads] for t in (q, k, v)]
        o, lse = fa.flash_attention_ref(*a, return_lse=True, **kw)
        grads = fa.flash_attention_bwd_ref(*a, o, do[:, :, h:h + heads], lse,
                                           **kw)
        for part, t in zip(parts, (o, lse) + tuple(grads)):
            part.append(t)
        del a, o, lse, grads
        torch.cuda.empty_cache()
    return tuple(torch.cat(part, 1 if i == 1 else 2)
                 for i, part in enumerate(parts))


def check_flash_pos(torch, dtype, S, world, H, D, timed_rank=None, seed=31):
    """The position forms of #2 and #6 against their plain twins on every
    (query chunk r, kv chunk s) pair of a ``world``-rank zig-zag ring over
    S tokens, B=1: the chunk calls a real ring makes. Whole tiles are then
    visible, masked (skipped) or on the diagonal, and the query half-chunk
    0 of rank 0 sees no key of another rank's chunk (lse -1e30, out 0).
    Tolerance (``_close_check``): out and every gradient within atol =
    rtol = 2e-2 (bf16) or 1e-4 (f32) entry by entry and 1e-2 (bf16) or
    1e-4 (f32) in relative norm; lse within atol = rtol = 1e-4, and -1e30
    exactly where the twin has it. With ``timed_rank`` r, times rank r's
    ring (its query chunk against the four kv chunks in ring order), the
    forward and the backward (with an lse cotangent) apart. Bound: the
    live pairs (q_pos >= kv_pos) of those calls, 4*D (forward) or 10*D
    (backward) flops each over the dtype's peak, against q, k, v, out,
    lse, positions (and dO, dq, dk, dv, dlse) over HBM; library: SDPA with
    the boolean position mask (forward; forward+backward minus forward)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    sl = S // world
    pos = _zigzag_positions(torch, S, world)
    q, k, v, do = (torch.randn((1, S, H, D), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    dl = torch.randn((1, H, sl), generator=g, device=dev) * 0.1

    def shard(x, r):
        return x[:, r * sl:(r + 1) * sl]

    err = {"fwd": 0.0, "bwd": 0.0}
    rel = {"fwd": 0.0, "bwd": 0.0}
    dead_rows = 0
    for r in range(world):
        for s in range(world):
            tag = f"flash pos {dtype} S={S} pair ({r}, {s})"
            args = (shard(q, r), shard(k, s), shard(v, s))
            pk = dict(q_positions=pos[r], kv_positions=pos[s])
            out, lse = fa.flash_attention_fwd(*args, return_lse=True, **pk)
            grads = fa.flash_attention_bwd(*args, out, shard(do, r), lse, dl,
                                           **pk)
            torch.cuda.synchronize()
            w_out, w_lse = fa.flash_attention_ref(*args, return_lse=True,
                                                  **pk)
            e, n = _close_check(tag + " out", out, w_out, dtype)
            err["fwd"], rel["fwd"] = max(err["fwd"], e), max(rel["fwd"], n)
            dead = w_lse == fa.NO_KEY_LSE
            if not bool((lse[dead] == fa.NO_KEY_LSE).all()) or bool(
                    out.transpose(1, 2)[dead].any()):
                raise AssertionError(f"{tag}: rows that see no key must "
                                     "give lse -1e30 and out 0")
            dead_rows += int(dead.sum())
            live = ~dead
            if not torch.allclose(lse[live], w_lse[live], atol=1e-4,
                                  rtol=1e-4):
                lerr = float((lse[live] - w_lse[live]).abs().max())
                raise AssertionError(f"{tag}: lse max abs err {lerr:.3g} "
                                     "beyond atol=rtol=1e-4")
            want = fa.flash_attention_bwd_ref(*args, out, shard(do, r), lse,
                                              dl, **pk)
            for name, a, b in zip(("dq", "dk", "dv"), grads, want):
                e, n = _close_check(f"{tag} {name}", a, b, dtype)
                err["bwd"], rel["bwd"] = max(err["bwd"], e), max(rel["bwd"],
                                                                 n)
            del out, lse, grads, w_out, w_lse, want
    torch.cuda.empty_cache()
    log(f"kernel flash pos {dtype} S={S} world={world} H={H} D={D}: 16 "
        f"zig-zag chunk pairs, {dead_rows} (head, row)s see no key; out "
        f"max abs err {err['fwd']:.3g} (relative norm {rel['fwd']:.3g}), "
        f"grads {err['bwd']:.3g} ({rel['bwd']:.3g})")
    if timed_rank is None:
        return None
    r = timed_rank
    calls = [((shard(q, r), shard(k, s), shard(v, s)),
              dict(q_positions=pos[r], kv_positions=pos[s]), s)
             for s in [(r - t) % world for t in range(world)]]
    live = sum(_live_pos_pairs(torch, pos[r], pos[s]) for _, _, s in calls)
    fwd = [fa.flash_attention_fwd(*a, return_lse=True, **pk)
           for a, pk, _ in calls]
    el, n = q.element_size(), len(calls)
    scale = 1.0 / D ** 0.5
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    io = el * sl * H * D                      # one [1, S/W, H, D] operand

    def bound(flops, nbytes):
        b_ops, b_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(b_ops, b_bytes),
                    bound_by="operations" if b_ops >= b_bytes else "bytes")

    rec_f = {"max_abs_err": err["fwd"], "live_pairs": live,
             **bound(4 * D * H * live, n * (4 * io + 4 * H * sl + 8 * sl))}
    rec_f["ms"] = time_ms(lambda: [fa.flash_attention_fwd(
        *a, return_lse=True, **pk) for a, pk, _ in calls])
    rec_f["plain_ms"] = time_ms(lambda: [fa.flash_attention_ref(
        *a, return_lse=True, **pk) for a, pk, _ in calls], warmup=1, reps=3)
    rec_f["library_ms"] = time_ms(lambda: [_pos_mask_sdpa(
        torch, *a, pk["q_positions"], pk["kv_positions"], scale)
        for a, pk, _ in calls])
    dor = shard(do, r)
    rec_b = {"max_abs_err": err["bwd"], "live_pairs": live,
             **bound(10 * D * H * live,
                     n * (8 * io + 4 * H * sl * 2 + 8 * sl))}
    rec_b["ms"] = time_ms(lambda: [fa.flash_attention_bwd(
        *a, o, dor, lse, dl, **pk) for (a, pk, _), (o, lse) in zip(calls,
                                                                 fwd)])
    rec_b["plain_ms"] = time_ms(lambda: [fa.flash_attention_bwd_ref(
        *a, o, dor, lse, dl, **pk) for (a, pk, _), (o, lse) in zip(calls,
                                                                 fwd)],
        warmup=1, reps=3)
    leaves = [[t.detach().requires_grad_() for t in a] for a, _, _ in calls]
    dot = dor.transpose(1, 2)

    def sdpa_fwd_bwd():
        for (a, pk, _), lv in zip(calls, leaves):
            o = _pos_mask_sdpa(torch, *lv, pk["q_positions"],
                               pk["kv_positions"], scale)
            torch.autograd.grad(o, lv, dot)

    rec_b["library_ms"] = time_ms(sdpa_fwd_bwd) - rec_f["library_ms"]
    for tag, rec in (("forward (#2 position form)", rec_f),
                     ("backward (#6 position form)", rec_b)):
        log(_row(f"flash pos {tag} {dtype} rank {r}'s ring, {n} calls, "
                 f"{live} live pairs a head", rec)
            + " library=sdpa with the boolean position mask")
    del fwd, leaves
    torch.cuda.empty_cache()
    return rec_f, rec_b


def check_ring_schedule(torch, S, world, H, D, dtype, seed=32):
    """The four-rank ring in one process: each simulated rank attends its
    query chunk to every kv chunk in ring order (the position form of #2
    through ``flash_attention_with_lse``) and merges with the ring's
    ``_lse_merge``; the result, un-permuted from the zig-zag layout, and
    the gradients of sum(out * ct) (through #6's position form with the
    lse cotangent) against full causal attention on the natural order by
    the plain twins (``_plain_attention``, four heads at a time).
    Tolerance: ``_close_check``."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.context_parallel \
        import _lse_merge
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    pos = _zigzag_positions(torch, S, world)
    perm = pos.reshape(-1).long()
    inv = torch.argsort(perm)
    nat = [torch.randn((1, S, H, D), generator=g, device=dev).to(dtype)
           for _ in range(3)]
    ct = torch.randn((1, S, H, D), generator=g, device=dev)
    lay = [x[:, perm].detach().requires_grad_() for x in nat]
    sl = S // world
    outs = []
    for r in range(world):
        acc = None
        for s in [(r - t) % world for t in range(world)]:
            o, lse = fa.flash_attention_with_lse(
                lay[0][:, r * sl:(r + 1) * sl], lay[1][:, s * sl:(s + 1) * sl],
                lay[2][:, s * sl:(s + 1) * sl], q_positions=pos[r],
                kv_positions=pos[s])
            acc = (o.float(), lse) if acc is None else _lse_merge(
                *acc, o.float(), lse)
        outs.append(acc[0].to(dtype))
    out = torch.cat(outs, 1)[:, inv]
    (out.float() * ct).sum().backward()
    got = [out.detach()] + [x.grad[:, inv] for x in lay]
    del outs, acc, out, lay
    torch.cuda.empty_cache()
    out, _, *grads = _plain_attention(torch, *nat, ct.to(dtype), causal=True)
    errs = [_close_check(f"ring schedule {dtype} S={S} {name}", a, b, dtype)
            for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                                  [out] + grads)]
    log(f"context: {world}-rank zig-zag ring schedule in one process, "
        f"{dtype} S={S} H={H} D={D}, against full causal attention (the "
        "plain twins): max abs err (relative norm) " + ", ".join(
            f"{n} {e:.3g} ({r:.3g})" for n, (e, r) in zip(
                ("out", "dq", "dk", "dv"), errs)))
    del got, out, grads, nat
    torch.cuda.empty_cache()


def phase_context(ident, S=16384, iters=3):
    """Context parallelism (``distributed/fleet/meta_parallel``) at
    ``llama2_7b``'s attention widths (32 heads of 128):

    (a) the position forms of #2 and #6 against their plain twins on the
        16 chunk pairs of a four-rank zig-zag ring over S tokens, bf16 and
        f32; rank 1's ring timed against its bound, the twins and SDPA;
    (b) the four-rank schedule in one process against full causal
        attention, forward and gradients (bf16 at S, f32 at S / 4);
    (c) the path: ``fleet.init`` with ``sep_degree=1`` on a one-rank NCCL
        world, then ``ring_flash_attention`` forward and backward on bf16
        ``[1, S, 32, 128]`` in a four-rank zig-zag layout, ``iters`` times
        (the launch counters zeroed just before and read just after), its
        last output and gradients against the plain twins on the same
        inputs (four heads at a time); then the flash ring against
        ``impl="xla"`` at S / 4, where the materialized logits fit.

    Returns (kernel rows, launches of the position forms)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import destroy_process_group, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention, zigzag_indices)
    from paddle_tpu_torch.incubate.nn.functional import ring_flash_attention

    t_phase = time.perf_counter()
    tc_ptxas("context")
    bf16, f32 = torch.bfloat16, torch.float32
    H, D, world = 32, 128, 4
    rec_f, rec_b = check_flash_pos(torch, bf16, S, world, H, D, timed_rank=1)
    check_flash_pos(torch, f32, S, world, H, D)
    check_ring_schedule(torch, S, world, H, D, bf16)
    check_ring_schedule(torch, S // 4, world, H, D, f32)

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    backend = dist.get_backend(hcg.get_sep_parallel_group().process_group)
    if hcg.get_sep_parallel_world_size() != 1 or backend != "nccl":
        raise AssertionError(f"context: sep group of "
                             f"{hcg.get_sep_parallel_world_size()} on "
                             f"{backend}, expected one rank on nccl")
    g = torch.Generator(device="cuda").manual_seed(33)

    def inputs(seq):
        pos = torch.from_numpy(zigzag_indices(seq, world)).cuda()
        qkv = [torch.randn((1, seq, H, D), generator=g, device="cuda")
               .to(bf16).requires_grad_() for _ in range(3)]
        do = torch.randn((1, seq, H, D), generator=g, device="cuda").to(bf16)
        return pos, qkv, do

    pos, qkv, do = inputs(S)

    def step():
        for t in qkv:
            t.grad = None
        out = ring_flash_attention(*qkv, causal=True, q_positions=pos,
                                   kv_positions=pos)
        out.backward(do)
        return out

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []

    def drive():
        for _ in range(iters):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out

    out, got = _counted(drive, needs=("flash_attention_fwd_pos",
                                      "flash_attention_bwd_pos"),
                        tc="context path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, n in got.items():
        if n and not name.startswith(("flash_attention_fwd",
                                      "flash_attention_bwd")):
            raise AssertionError(f"context: the ring launched {name}")
    if got["flash_attention_fwd"] != got["flash_attention_fwd_pos"]:
        raise AssertionError(f"context: causal ring chunks left position "
                             f"mode: {got}")
    if out.shape != (1, S, H, D):
        raise AssertionError(f"context: ring output {tuple(out.shape)}")
    # the last iteration's output and gradients against the plain twins on
    # the same inputs (the one chunk of a one-rank ring)
    want = _plain_attention(torch, *[t.detach() for t in qkv], do,
                            q_positions=pos, kv_positions=pos)
    path_errs = [_close_check(f"context path S={S} {name}", a, b, bf16)
                 for name, a, b in zip(("out", "dq", "dk", "dv"),
                                       [out.detach()] + [t.grad for t in qkv],
                                       want[:1] + want[2:])]
    del want
    launches = {"flash_attention_fwd_pos": got["flash_attention_fwd_pos"],
                "flash_attention_bwd_pos": got["flash_attention_bwd_pos"]}
    log(f"context: ring_flash_attention through fleet.init (sep_degree=1, "
        f"one-rank NCCL world), bf16 [1, {S}, {H}, {D}], zig-zag positions, "
        f"forward + backward: " + " ".join(f"{s * 1e3:.1f}" for s in secs)
        + f" ms ({iters} iterations; median "
        f"{statistics.median(secs) * 1e3:.1f}), peak {peak:.2f} GiB, "
        f"launches {launches} [{ident}]; against the plain twins: max abs "
        "err (relative norm) " + ", ".join(
            f"{n} {e:.3g} ({r:.3g})" for n, (e, r) in zip(
                ("out", "dq", "dk", "dv"), path_errs)))
    del qkv, do, out
    torch.cuda.empty_cache()

    # the flash ring against the materialized-logits ring at S / 4
    pos, qkv, do = inputs(S // 4)
    res = []
    for impl in ("flash", "xla"):
        leaves = [t.detach().requires_grad_() for t in qkv]
        o = ring_attention(*leaves, causal=True, q_positions=pos,
                           kv_positions=pos, impl=impl)
        o.backward(do)
        res.append([o.detach()] + [t.grad for t in leaves])
        del o, leaves
    errs = [_close_check(f"context ring flash vs xla {name}", a, b, bf16)
            for name, a, b in zip(("out", "dq", "dk", "dv"), *res)]
    log(f"context: ring_attention flash vs impl='xla' at S={S // 4} bf16: "
        "max abs err (relative norm) " + ", ".join(
            f"{n} {e:.3g} ({r:.3g})" for n, (e, r) in zip(
                ("out", "dq", "dk", "dv"), errs)))
    del res
    destroy_process_group()
    torch.cuda.empty_cache()
    log(f"context: phase took {time.perf_counter() - t_phase:.1f} s")
    return ({"flash_attention_fwd_pos": rec_f,
             "flash_attention_bwd_pos": rec_b}, launches)


# one row per TPU kernel of the repo that the port has replaced: the row's
# name, the CUDA source that serves it, the Pallas function it replaces,
# and the launch counter (the wrapper) whose launches it is charged with
KERNELS = {
    "paged_decode_attention": dict(
        tpu_kernel=1, source="paddle_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:446"),
    "flash_attention_fwd": dict(
        tpu_kernel=2, source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:136"),
    "paged_verify_attention": dict(
        tpu_kernel=3, source="paddle_tpu_torch/csrc/paged_verify_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:661"),
    "paged_decode_attention_v1": dict(
        tpu_kernel=4,
        source="paddle_tpu_torch/csrc/paged_decode_attention_v1.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:113"),
    "flash_attention_bwd_fused": dict(
        tpu_kernel=5, source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:229"),
    "flash_attention_bwd_split": dict(
        tpu_kernel=6, source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:361"),
    # the position-masked forms of #2 and #6 (q_positions / kv_positions),
    # the chunk attention of ring attention
    "flash_attention_fwd_pos": dict(
        tpu_kernel=2, source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:136"),
    "flash_attention_bwd_pos": dict(
        tpu_kernel=6, source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:361"),
    "causal_flash_fwd": dict(
        tpu_kernel=7, source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/causal_flash.py:112"),
    "causal_flash_fwd_tiled": dict(
        tpu_kernel=8, source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/causal_flash.py:256"),
    "causal_flash_fwd_row": dict(
        tpu_kernel=9, source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/causal_flash.py:360"),
    "causal_flash_bwd_tiled": dict(
        tpu_kernel=10, source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/causal_flash.py:516"),
    "causal_flash_bwd": dict(
        tpu_kernel=11, source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/causal_flash.py:598"),
    "quant_matmul": dict(
        tpu_kernel=12, source="paddle_tpu_torch/csrc/quant_matmul.cu",
        replaces="paddle_tpu/ops/pallas/quant_matmul.py:184"),
    "grouped_matmul": dict(
        tpu_kernel=13, source="paddle_tpu_torch/csrc/grouped_matmul.cu",
        replaces="paddle_tpu/ops/pallas/grouped_matmul.py:92"),
    "decode_attention": dict(
        tpu_kernel=14, source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention.py:63"),
    "decode_attention_slab": dict(
        tpu_kernel=15, source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention.py:241"),
}
# the time of the FMA-only flash kernel that each flash row's tensor-core
# body replaced, at the same shape, from earlier full runs of this script
# (H100 80GB HBM3, 700 W); only the log's "flash row" lines read it
FMA_BEFORE = {
    "flash_attention_fwd": 4.2502,
    "flash_attention_bwd_fused": 4.5087,
    "flash_attention_bwd_split": 10.9615,
    "flash_attention_fwd_pos": 31.7969,
    "flash_attention_bwd_pos": 100.0360,
    "causal_flash_fwd": 0.9386,
    "causal_flash_fwd_tiled": 9.0901,
    "causal_flash_fwd_row": 4.4158,
    "causal_flash_bwd_tiled": 10.9307,
    "causal_flash_bwd": 4.5202,
}
# the rows that only the generate phase launches
GENERATE_ROWS = ("paged_decode_attention_v1", "decode_attention",
                 "decode_attention_slab")
# the rows that only the context phase launches (it fails unless both are)
CONTEXT_ROWS = ("flash_attention_fwd_pos", "flash_attention_bwd_pos")


# ------------------------------------------------------------ phase tp
TP_DEADLINE_S = 900   # the rank world's wall clock, as a hang guard
TP_F32_LAYERS = 8     # llama2_7b f32 identity, of 32
TP_BF16_LAYERS = 32   # llama2_7b bf16 timing
TP_MOE_F32_LAYERS = 2   # Mixtral widths, f32 identity
TP_MOE_BF16_LAYERS = 8  # Mixtral widths, bf16 timing
TP_FUSED_F32_LAYERS = 2
TP_FUSED_BF16_LAYERS = 8
TP_LABEL = "two ranks sharing one H100 over gloo"


def _tp_items(lens, new, sampled=(), seed=91, vocab=32000):
    """[(prompt, new tokens, temperature, seed)]: one prompt a length in
    ``lens``, the requests at indices ``sampled`` at temperature 0.8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (n,)), new,
             0.8 if i in sampled else 0.0, 100 + i)
            for i, n in enumerate(lens)]


def _tp_hash(eng):
    """A running sha256 of every command output this rank keeps (each
    fetched: the identity passes only), and the count of commands."""
    import hashlib

    import torch

    h = hashlib.sha256()
    n = [0]
    keep = eng.runner._keep

    def rec(seq, out):
        outs = out if isinstance(out, (tuple, list)) else (
            () if out is None else (out,))
        for t in outs:
            if isinstance(t, torch.Tensor):
                h.update(t.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
        n[0] += 1
        keep(seq, out)

    eng.runner._keep = rec
    return lambda: (h.hexdigest(), n[0])


def _tp_timed_reduce():
    """Time the tensor-parallel all-reduce of ``models/llama.py`` on this
    rank: the device is synchronised first (so the wait for the GEMMs
    before it is not counted), then the host wall of the gloo call, which
    returns once the sum is back on the card. Returns (the totals, a
    function that restores the original)."""
    import torch

    from paddle_tpu_torch.models import llama

    orig = llama._tp_reduce
    tot = {"s": 0.0, "n": 0}

    def timed(t, group):
        if group is None:
            return t
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, group)
        tot["s"] += time.perf_counter() - t0
        tot["n"] += 1
        return out

    llama._tp_reduce = timed
    return tot, lambda: setattr(llama, "_tp_reduce", orig)


def _tp_free():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _tp_serve(rank, make, items, counts, needs=(), tag="", timed=False,
                hashed=False):
    """One sharded engine run: every rank builds ``make()``; rank 0
    serves ``items`` (launch counters zeroed just before and read just
    after, on every rank) and closes; the others run their follower loop.
    Returns this rank's record."""
    import torch

    eng = make()
    rec = {}
    digest = _tp_hash(eng) if hashed else None
    tot, restore = _tp_timed_reduce() if timed else (None, None)
    torch.cuda.reset_peak_memory_stats()
    try:
        if eng.is_leader:
            def run():
                return _serve_items(eng, items, tag)
            (reqs, wall), got = _counted(run, needs)
            eng.close()
            rec.update(tokens=[list(r.tokens) for r in reqs], wall=wall,
                       ttft=[(r._t_first - r._t_arrival) * 1e3
                             for r in reqs],
                       moe=eng.moe_stats() if eng._moe_stats_n else None)
        else:
            _, got = _counted(eng.run)
    finally:
        if restore is not None:
            restore()
    torch.cuda.synchronize()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = {k: v for k, v in got.items() if v}
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    if digest is not None:
        rec["digest"] = digest()
    if tot is not None:
        rec["collective_s"], rec["collectives"] = tot["s"], tot["n"]
    if eng._moe_stats_n:
        rec["local_experts"] = int(
            eng.model.model.layers[0].mlp.experts_gate.shape[0])
    del eng
    _tp_free()
    return rec


def _tp_baseline(rank, make, items, tag):
    """Rank 0: the same items on the tp/ep=None engine (graphs on), its
    streams; then freed. The other rank waits."""
    import torch.distributed as dist

    out = None
    if rank == 0:
        eng = _pin(make())
        reqs, wall = _serve_items(eng, items, tag)
        out = dict(tokens=[list(r.tokens) for r in reqs], wall=wall,
                   moe=eng.moe_stats() if eng._moe_stats_n else None)
        del eng, reqs
        _tp_free()
    dist.barrier()
    return out


def _tp_dense(rank, counts):
    """(a) tp=2 at llama2_7b's widths (see ``phase_tp``)."""
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b

    res = {}
    lens = [16, 64, 128, 200, 256, 300, 400, 512]
    kw = dict(max_slots=8, num_pages=512, page_size=16, chunk_size=16,
              device="cuda")
    modes = dict(prefill_chunk=256, prefix_cache=True, spec="ngram",
                 spec_k=4)
    cfg = llama2_7b()
    cfg.num_layers = TP_F32_LAYERS
    items = _tp_items(lens, 24, sampled=(2, 5))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def model():
            return init_llama(cfg, seed=0, device="cuda",
                              dtype=torch.float32)
        res["f32_base"] = _tp_baseline(
            rank, lambda: Engine(model(), **kw, **modes), items,
            "tp f32 tp=None")
        res["f32"] = _tp_serve(
            rank, lambda: _pin(Engine(model(), tp=2, **kw, **modes)), items,
            counts, needs=("paged_verify_attention",), tag="tp f32 tp=2",
            hashed=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cfg = llama2_7b()
    cfg.num_layers = TP_BF16_LAYERS
    items = _tp_items(lens, 32)
    # chains of 16 tokens: the first token lands at the first step's fetch
    kw16 = dict(kw, max_chain=1)

    def model16():
        return init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    res["bf16_base"] = _tp_baseline(rank, lambda: Engine(model16(), **kw16),
                                    items, "tp bf16 tp=None")
    res["bf16"] = _tp_serve(
        rank, lambda: _pin(Engine(model16(), tp=2, **kw16)), items, counts,
        needs=("flash_attention_fwd", "paged_decode_attention"),
        tag="tp bf16 tp=2", timed=True)
    return res


def _tp_moe(rank, counts):
    """(b) ep=2 at Mixtral-8x7B's expert widths (see ``phase_tp``)."""
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine

    res = {}
    kw = dict(max_slots=8, num_pages=256, page_size=16, chunk_size=16,
              device="cuda")
    lens = [16, 40, 64, 100, 128, 160, 200, 256]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = mixtral_8x7b(num_layers=TP_MOE_F32_LAYERS, max_position=4096)
        items = _tp_items(lens, 16, sampled=(1,))

        def model():
            return init_llama(cfg, seed=0, device="cuda",
                              dtype=torch.float32)
        res["f32_base"] = _tp_baseline(rank, lambda: Engine(model(), **kw),
                                       items, "ep f32 ep=None")
        res["f32"] = _tp_serve(
            rank, lambda: _pin(Engine(model(), ep=2, **kw)), items, counts,
            needs=("grouped_matmul",), tag="ep f32 ep=2", hashed=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cfg = mixtral_8x7b(num_layers=TP_MOE_BF16_LAYERS, max_position=4096)
    items = _tp_items(lens, 32)
    res["bf16"] = _tp_serve(
        rank, lambda: _pin(Engine(init_llama(cfg, seed=0, device="cuda",
                                             dtype=torch.bfloat16),
                                  ep=2, **kw)),
        items, counts, needs=("grouped_matmul",), tag="ep bf16 ep=2",
        timed=False)
    return res


def _tp_fused(rank, counts):
    """(d) ``FusedMultiTransformer`` at nranks=2, GPT-3 6.7B widths, B=8:
    f32 on each cache kind against nranks=1 on rank 0 (same weights), then
    bf16 ms a decode step."""
    import torch

    from paddle_tpu_torch.convert import init_fused_multi_transformer

    res = {}
    kinds = {k: FUSED_KINDS[k] for k in ("5d", "slab", "paged_kv")}
    g = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn((8, 48, 4096), generator=g, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        layer = init_fused_multi_transformer(
            4096, 32, 16384, TP_FUSED_F32_LAYERS, seed=0, device="cuda",
            dtype=torch.float32, nranks=2)
        outs = {}

        def f32_pass():
            for kind in kinds:
                outs[kind], _ = _fused_run(layer, kind, x, 32)
        _, got = _counted(f32_pass, ("flash_attention_fwd",)
                          + tuple(kinds.values()))
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        res["f32_launches"] = {k: v for k, v in got.items() if v}
        del layer
        _tp_free()
        if rank == 0:
            one = init_fused_multi_transformer(
                4096, 32, 16384, TP_FUSED_F32_LAYERS, seed=0,
                device="cuda", dtype=torch.float32)
            errs = {}
            for kind in kinds:
                want, _ = _fused_run(one, kind, x, 32)
                top = float(want.abs().max())
                errs[kind] = (float((outs[kind] - want).abs().max()), top)
            res["f32_errs"] = errs
            del one
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del outs, x
    _tp_free()
    layer = init_fused_multi_transformer(
        4096, 32, 16384, TP_FUSED_BF16_LAYERS, seed=0, device="cuda",
        dtype=torch.bfloat16, nranks=2)
    xb = torch.randn((8, 160, 4096), generator=g,
                     device="cuda").to(torch.bfloat16)
    ms = {}

    def bf16_pass():
        for kind in kinds:
            _, ms[kind] = _fused_run(layer, kind, xb, 128)
    _, got = _counted(bf16_pass, tuple(kinds.values()))
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    res["bf16_ms"] = ms
    res["bf16_launches"] = {k: v for k, v in got.items() if v}
    del layer, xb
    _tp_free()
    return res


def _tp_gpt(rank):
    """(d) ``examples/generate_gpt_tp_torch.py``'s path at GPT-2 small,
    mp=2: ``fleet.init``, ``distributed_model``, greedy ``generate``
    (f32), held against mp=1 and across the ranks."""
    import importlib.util

    root = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "generate_gpt_tp_torch", root / "examples"
        / "generate_gpt_tp_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    args = ex.parse_args(["--mp", "2", "--check", "--device", "cuda",
                          "--backend", "gloo"])
    return ex.generate_in_world(args, 2)


def _tp_rank(rank, world, init_file, out_dir):
    """One rank of the tp phase's world: gloo over CUDA tensors on the
    one card."""
    import datetime

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    from paddle_tpu_torch.distributed import (destroy_process_group,
                                              init_parallel_env)

    init_parallel_env(device="cuda", backend="gloo",
                      init_method=f"file://{init_file}", rank=rank,
                      world_size=world,
                      timeout=datetime.timedelta(seconds=600))
    counts, res = {}, {}
    t0 = time.perf_counter()
    res["a"] = _tp_dense(rank, counts)
    res["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["b"] = _tp_moe(rank, counts)
    res["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["d"] = _tp_fused(rank, counts)
    res["gpt"] = _tp_gpt(rank)
    res["d_s"] = time.perf_counter() - t0
    res["counts"] = counts
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    destroy_process_group()


def _tp_shard_kernels(torch, ident):
    """The kernels of the tp phase's path at its shard shapes, each against
    its plain version (the tolerances of the kernels phase), timed: #1 and
    #3 at llama2_7b's 16 heads a rank, #2 there on a 512-token prefill
    wave, #13 over Mixtral's 4 local experts (decode capacity 3), #4, #14
    and #15 at the fused layer's 16 heads a rank. Logged as their own
    "tp shard" lines, not as kernel rows."""
    bf16 = torch.bfloat16
    tol = dict(atol=2e-2, rtol=2e-2)
    lengths = [0, 1, 17, 300, 1000, 2049, 3333, 4096]
    r = check_decode(torch, bf16, False, 8, 16, 16, 128, 16, 256, lengths,
                     timed=True, **tol)
    log(_row(f"tp shard paged_decode_attention bf16 B=8 H=16 Hkv=16 D=128 "
             f"lengths={lengths} [{ident}]", r))
    r = check_flash(torch, bf16, 8, 512, 16, 128, timed=True, **tol)
    log(_row(f"tp shard flash_attention_fwd bf16 B=8 S=512 H=16 D=128 "
             f"causal [{ident}]", r))
    for tag, m, bases in (("spec verify", 5, [0, 1, 17, 300, 1000, 2049,
                                              3333, 4094]),
                          ("chunked prefill", 256, [0, 0, 256, 512, 1000,
                                                    2048, 3000, 3840])):
        r = check_verify(torch, bf16, False, 8, m, 16, 16, 128, 16, 256,
                         bases, timed=True, **tol)
        log(_verify_row(f"tp shard H=16 bf16 {tag} B=8 m={m} D=128 "
                        f"[{ident}]", r))
    for K, N in ((4096, 14336), (14336, 4096)):
        r = check_grouped(torch, bf16, K, N, 3, [3, 1, 0, 2], timed=True)
        log(_row(f"tp shard grouped_matmul bf16 K={K} N={N} C=3 E=4 "
                 f"(ep=2's local experts) valid=[3, 1, 0, 2] [{ident}]", r)
            + f" body={r['body']}")
    big_lens = [129, 300, 511, 640, 777, 900, 1024, 1152]
    for slab in (True, False):
        r = check_contig_decode(torch, bf16, slab, 8, 16, 16, 128, 1152,
                                big_lens, timed=True)
        name = "decode_attention_slab" if slab else "decode_attention"
        log(_row(f"tp shard {name} bf16 B=8 H=16 D=128 S=1152 "
                 f"lengths={big_lens} [{ident}]", r))
    r = check_v1_decode(torch, bf16, False, 8, 16, 16, 128, 16, 72,
                        big_lens, timed=True)
    log(_row(f"tp shard paged_decode_attention_v1 bf16 B=8 H=16 D=128 "
             f"ps=16 lengths={big_lens} [{ident}]", r))


def phase_tp(ident):
    """Tensor- and expert-parallel serving and config 3 at nranks=2, as two
    rank processes sharing the one card over gloo (CUDA tensors: NCCL
    refuses two ranks on one device). Every number here is labelled
    "two ranks sharing one H100 over gloo": it is not a TP speed.

    First the shard-shape kernels (``_tp_shard_kernels``). Then one
    two-rank world (``torch.multiprocessing``, a ``file://`` rendezvous):

    (a) ``Engine(tp=2)`` at ``llama2_7b()`` widths (32 heads, 16 a rank;
        FF 11008, 5504 a rank): f32, TF32 off, 8 of 32 layers, 8 requests
        (prompts 16-512, two sampled) with chunked prefill 256, the prefix
        cache and n-gram k=4: rank 0's streams must equal the tp=None
        engine's on the same card and weights, and both ranks' command
        outputs must hash alike; then bf16 at 32 layers, 8 requests of 32
        tokens in chains of 16: tok/s, TTFT, each rank's peak memory, the
        all-reduce's share of the pass, and how many rows agree with
        tp=None.
    (b) ``Engine(ep=2)`` at Mixtral-8x7B's widths: f32, 2 of 32 layers,
        streams and router stats equal to ep=None; bf16, 8 layers: tok/s
        and #13's launches over the 4 local experts.
    (c) tp=2 x ep=2 needs four processes on the one card: it runs in the
        CPU tests only (``tests/test_torch_ep_serving.py``).
    (d) Config 3: ``FusedMultiTransformer`` at nranks=2, GPT-3 6.7B widths,
        B=8, on the 5-D (#14), slab (#15) and ``PagedKVCache`` (#4) caches:
        f32 (2 layers) against nranks=1 on the same weights, within 1e-4
        of the largest entry; bf16 (8 layers) ms a decode step. Then
        ``examples/generate_gpt_tp_torch.py``'s path at GPT-2 small, mp=2:
        greedy tokens equal to mp=1.

    The launches of every pass, both ranks', are returned."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    _tp_shard_kernels(torch, ident)
    # the rank processes share the card with this one: give back what
    # earlier phases left cached
    _tp_free()
    log(f"tp: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB of the card while the ranks run")
    t_world = time.perf_counter()
    out = tempfile.mkdtemp(prefix="tp_phase_")
    ctx = mp.start_processes(_tp_rank, args=(2, os.path.join(out, "init"),
                                             out),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t_world > TP_DEADLINE_S:
                raise AssertionError(f"tp: the rank world outlived "
                                     f"{TP_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    shutil.rmtree(out, ignore_errors=True)
    lead = ranks[0]
    # (a)
    a0, a1 = lead["a"], ranks[1]["a"]
    if a0["f32"]["tokens"] != a0["f32_base"]["tokens"]:
        raise AssertionError("tp f32: tp=2 streams differ from tp=None's")
    if a0["f32"]["digest"] != a1["f32"]["digest"]:
        raise AssertionError("tp f32: the ranks' command outputs differ")
    log(f"tp (a) f32 llama2_7b widths, {TP_F32_LAYERS} of 32 layers, "
        f"chunked 256 + prefix cache + ngram k=4, 8 requests (2 sampled): "
        f"tp=2 streams equal tp=None's; both ranks' {a0['f32']['digest'][1]}"
        f" command outputs hash alike; launches rank 0 "
        f"{a0['f32']['launches']} rank 1 {a1['f32']['launches']} [{ident}]")
    b16, base16 = a0["bf16"], a0["bf16_base"]
    toks = sum(len(t) for t in b16["tokens"])
    agree = sum(t == u for t, u in zip(b16["tokens"], base16["tokens"]))
    log(f"tp (a) bf16 llama2_7b, {TP_BF16_LAYERS} layers, tp=2 ({TP_LABEL}):"
        f" 8 requests, {toks} tokens in {b16['wall']:.3f} s = "
        f"{toks / b16['wall']:.1f} tok/s (tp=None on the card: "
        f"{toks / base16['wall']:.1f} tok/s); TTFT ms median "
        f"{statistics.median(b16['ttft']):.1f} max {max(b16['ttft']):.1f};"
        f" peak GiB rank 0 {b16['peak_gib']:.2f} rank 1 "
        f"{ranks[1]['a']['bf16']['peak_gib']:.2f}; all-reduce "
        f"{b16['collectives']} calls {b16['collective_s']:.3f} s = "
        f"{b16['collective_s'] / b16['wall']:.1%} of the pass (rank 1 "
        f"{ranks[1]['a']['bf16']['collective_s']:.3f} s); rows equal to "
        f"tp=None {agree} of 8; launches {b16['launches']} [{ident}]")
    # (b)
    m0, m1 = lead["b"], ranks[1]["b"]
    if m0["f32"]["tokens"] != m0["f32_base"]["tokens"]:
        raise AssertionError("ep f32: ep=2 streams differ from ep=None's")
    if m0["f32"]["moe"]["expert_load"] != m0["f32_base"]["moe"][
            "expert_load"]:
        raise AssertionError("ep f32: router stats differ from ep=None's")
    if m0["f32"]["digest"] != m1["f32"]["digest"]:
        raise AssertionError("ep f32: the ranks' command outputs differ")
    mb = m0["bf16"]
    mtoks = sum(len(t) for t in mb["tokens"])
    if mb["local_experts"] != 4:
        raise AssertionError(f"ep bf16: {mb['local_experts']} local experts")
    log(f"tp (b) ep=2 Mixtral-8x7B widths: f32 {TP_MOE_F32_LAYERS} layers "
        f"streams and router stats equal ep=None's, ranks hash alike; bf16 "
        f"{TP_MOE_BF16_LAYERS} layers ({TP_LABEL}): {mtoks} tokens in "
        f"{mb['wall']:.3f} s = {mtoks / mb['wall']:.1f} tok/s; #13 launches "
        f"over {mb['local_experts']} local experts rank 0 "
        f"{mb['launches'].get('grouped_matmul', 0)} rank 1 "
        f"{m1['bf16']['launches'].get('grouped_matmul', 0)}; peak GiB "
        f"{mb['peak_gib']:.2f} / {m1['bf16']['peak_gib']:.2f} [{ident}]")
    # (d)
    d = lead["d"]
    for kind, (err, top) in d["f32_errs"].items():
        if not (math.isfinite(top) and err <= 1e-4 * top):
            raise AssertionError(f"tp fused f32 {kind}: nranks=2 off "
                                 f"nranks=1 by {err:.3g} (largest {top:.3g})")
    log(f"tp (d) FusedMultiTransformer nranks=2 GPT-3 6.7B widths B=8: f32 "
        f"{TP_FUSED_F32_LAYERS} layers against nranks=1, max abs err / "
        f"largest entry "
        + ", ".join(f"{k} {e:.3g}/{t:.3g}" for k, (e, t)
                    in d["f32_errs"].items())
        + f" (limit 1e-4 of it); bf16 {TP_FUSED_BF16_LAYERS} layers ms a "
        f"decode step ({TP_LABEL}, host clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in d["bf16_ms"].items())
        + f"; launches {d['bf16_launches']} [{ident}]")
    gpt = lead["gpt"]
    if not (gpt["ranks_equal"] and gpt["equals_mp1"] and gpt["fused_ok"]):
        raise AssertionError(f"tp (d) generate_gpt_tp: {gpt}")
    log(f"tp (d) generate_gpt_tp_torch path GPT-2 small mp=2: greedy tokens "
        f"equal mp=1's and across the ranks; {json.dumps(gpt)} [{ident}]")
    counts = {}
    for r in ranks:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    log(f"tp: world parts (a) {lead['a_s']:.1f} s (b) {lead['b_s']:.1f} s "
        f"(d) {lead['d_s']:.1f} s; launches both ranks "
        f"{({k: v for k, v in counts.items() if v})}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {name: counts.get(name, 0) for name in KERNELS}


# ------------------------------------------------------------ phase dp
DP_DEADLINE_S = 600   # the rank world's wall clock, as a hang guard
DP_STEPS = 4          # (a): BERT-base at dp=2
DP_ZERO_LAYERS = 2    # (b): BERT-base widths, 2 of 12 layers
DP_ZERO_STEPS = 2
DP_SBN_IMAGES = 128   # (c): 2 steps of 32 images a rank, 224 x 224
DP_LOSS_RTOL = 1e-5   # f32 sums in another order
DP_PARAM_ATOL = 1e-5  # (b): ZeRO against dp, the same gradients
DP_PARAM_REL = 1e-3   # (a): see _dp_compare
DP_BN_TOL = 1e-4      # (c) step 1: of each running buffer's largest entry
# (c) against one process of SyncBatchNorm's arithmetic: step 1's update
# (relative norm) and step 2's buffers (of the largest entry). On the
# H100 SyncBatchNorm at dp=2 reads 0.0194 and 3.43e-4, the planted
# rank-local backward 0.311 and 8.19e-3 (PERF.md); each limit sits near
# the geometric mean of the two
DP_SBN_UPDATE_REL = 0.08
DP_SBN_STEP2_TOL = 2e-3
DP_LABEL = "two ranks sharing one H100 over gloo"


def _dp_cfg(layers=None):
    """(BertConfig, global batch, seq): BERT-base, 32 x 512 (the bert
    phase's one-GPU batch)."""
    ex = _example("train_bert_dp_torch")
    cfg, _, seq = ex.configs(True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    return cfg, 32, seq


def _dp_batches(n):
    import numpy as np

    ex = _example("train_bert_dp_torch")
    cfg, batch, seq = _dp_cfg()
    rng = np.random.default_rng(0)
    return [ex.global_batch(rng, cfg.vocab_size, batch, seq)
            for _ in range(n)]


def _dp_digest(model):
    """sha256 of every parameter's bytes (on the host)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for _, p in sorted(model.state_dict().items()):
        h.update(p.detach().cpu().contiguous().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_bert_run(rows, steps, wrap, layers=None, on_step=None):
    """BERT (from seed 0) on the card, trained ``steps`` eager steps on
    ``rows`` of the shared global batches: ``wrap(model, AdamW(1e-4,
    grad_clip=ClipGradByGlobalNorm(1.0)))`` gives (the model to call, the
    optimizer to step). Returns (model, optimizer, losses, host s, device
    ms a step)."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import init_bert
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    cfg, _, _ = _dp_cfg(layers)
    model = init_bert(cfg, seed=0, device="cuda")
    model.train()
    call, opt = wrap(model, optimizer.AdamW(
        learning_rate=1e-4, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    crit = BertPretrainingCriterion(cfg.vocab_size)
    losses, host, devms = [], [], []
    for i, (ids, labels) in enumerate(_dp_batches(steps)):
        ids = torch.from_numpy(ids[rows]).cuda()
        labels = torch.from_numpy(labels[rows]).cuda()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        loss = crit(call(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        e1.record()
        torch.cuda.synchronize()
        devms.append(e0.elapsed_time(e1))
        host.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(i, model, opt)
    return model, opt, losses, host, devms


def _dp_timed_reduce():
    """Time the dp gradient all-reduce of ``fleet.utils``
    (``allreduce_buckets``, which ``HybridParallelOptimizer`` calls): the
    device is synchronised first, then the host wall of the bucketed gloo
    calls. Returns (the totals, a function that restores the original)."""
    import torch

    from paddle_tpu_torch.distributed.fleet.utils import \
        hybrid_parallel_util as hpu

    orig = hpu.allreduce_buckets
    tot = {"s": 0.0, "calls": 0}

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = orig(*a, **k)
        tot["s"] += time.perf_counter() - t0
        tot["calls"] += n
        return n

    hpu.allreduce_buckets = timed
    return tot, lambda: setattr(hpu, "allreduce_buckets", orig)


def _dp_free():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _dp_bert(rank, out_dir):
    """(a) Config 2 at dp=2 through fleet: each step's loss on this
    rank's 16 rows, host and device time, the all-reduce's time and
    buckets, a digest of the parameters after every step, peak memory."""
    import torch

    from paddle_tpu_torch.distributed import fleet

    ex = _example("train_bert_dp_torch")
    _, batch, _ = _dp_cfg()
    rows = ex.rank_rows(batch, rank, 2)
    digests, buckets, reduce_s = [], [], []

    def wrap(model, opt):
        return fleet.distributed_model(model), \
            fleet.distributed_optimizer(opt)

    def on_step(i, model, opt):
        reduce_s.append(tot["s"] - sum(reduce_s))
        digests.append(_dp_digest(model))
        buckets.append(opt.last_buckets)

    tot, restore = _dp_timed_reduce()
    torch.cuda.reset_peak_memory_stats()
    try:
        model, opt, losses, host, devms = _dp_bert_run(
            rows, DP_STEPS, wrap, on_step=on_step)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()},
                   os.path.join(out_dir, "a_params.pt"))
    del model, opt
    _dp_free()
    return dict(losses=losses, host=host, dev=devms, digests=digests,
                buckets=buckets, reduce_s=reduce_s,
                reduce_calls=tot["calls"], peak_gib=peak, rows=list(rows))


def _dp_zero(rank, out_dir):
    """(b) BERT-base widths at DP_ZERO_LAYERS layers, DP_ZERO_STEPS steps:
    dp (fleet), then ``group_sharded_parallel`` at os, os_g, p_g_os over
    the two ranks; each one's parameters against dp's, memory at rest and
    at peak over the same baseline, and (d) the os state saved by both
    ranks and loaded back on rank 0 alone."""
    import torch

    from paddle_tpu_torch.distributed import (fleet, get_group,
                                              load_state_dict,
                                              save_state_dict)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    ex = _example("train_bert_dp_torch")
    _, batch, _ = _dp_cfg()
    rows = ex.rank_rows(batch, rank, 2)
    out, base_params = {}, None
    for mode in ("dp", "os", "os_g", "p_g_os"):
        _dp_free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def wrap(model, opt, mode=mode):
            if mode == "dp":
                return fleet.distributed_model(model), \
                    fleet.distributed_optimizer(opt)
            m, o, _ = group_sharded_parallel(model, opt, mode)
            return m, o

        model, opt, losses, host, _ = _dp_bert_run(
            rows, DP_ZERO_STEPS, wrap, layers=DP_ZERO_LAYERS)
        rest = (torch.cuda.memory_allocated() - base) / 2**30
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        rec = dict(losses=losses, host=host, rest_gib=rest, peak_gib=peak)
        if mode == "p_g_os":
            opt.gather_params()
        params = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        if mode == "dp":
            base_params = params
        else:
            errs = {k: float((params[k] - v).abs().max())
                    for k, v in base_params.items()}
            rec["err"] = max(errs.values())
            rec["errs"] = errs
            rec["sharded"] = len(opt.sharded)
        if mode == "os":  # (d)
            path = os.path.join(out_dir, "zero_os_ckpt")
            sd = {f"model.{k}": v for k, v in params.items()}
            sd.update({f"opt.{k}": v for k, v in
                       opt.sharded_state_dict().items()})
            t0 = time.perf_counter()
            save_state_dict(sd, path, group=get_group())
            rec["save_s"] = time.perf_counter() - t0
            gathered = opt.gathered_state_dict()
            if rank == 0:
                t0 = time.perf_counter()
                got = load_state_dict(path)
                rec["load_s"] = time.perf_counter() - t0
                bad = [k for k, v in gathered.items()
                       if isinstance(v, torch.Tensor)
                       and not torch.equal(got[f"opt.{k}"], v.cpu())]
                bad += [k for k, v in params.items()
                        if not torch.equal(got[f"model.{k}"], v.cpu())]
                rec["ckpt"] = dict(bad=bad, tensors=len(got),
                                   bytes=sum(os.path.getsize(
                                       os.path.join(path, f))
                                       for f in os.listdir(path)))
            del gathered
        out[mode] = rec
        del model, opt, params
    del base_params
    _dp_free()
    return out


def _dp_resnet_data(n, size):
    import numpy as np

    from paddle_tpu_torch.io import Dataset

    X, Y = _resnet_data(np, n, size, 1000, 1)

    class DS(Dataset):
        def __init__(self, order):
            self.order = order

        def __len__(self):
            return len(self.order)

        def __getitem__(self, i):
            j = self.order[i]
            return X[j], Y[j]

    return DS


def _dp_bn_err(got, want):
    """For each step, (the worst buffer's max abs difference over its
    largest entry, that buffer's name)."""
    out = []
    for g, w in zip(got, want):
        out.append(max((float((g[k] - v).abs().max())
                        / max(float(v.abs().max()), 1e-30), k)
                       for k, v in w.items()))
    return out


def _dp_update_err(got, want):
    """The norm of the difference of two first-step updates (each
    parameter after step 1 less before) over the norm of ``want``."""
    diff2 = sum(float((got[k] - v).double().square().sum())
                for k, v in want.items())
    norm2 = sum(float(v.double().square().sum()) for v in want.values())
    return (diff2 / norm2) ** 0.5


def _dp_bn_stats(net):
    return {k: v.detach().cpu().clone() for k, v in net.named_buffers()
            if k.endswith("_mean") or k.endswith("_variance")}


def _dp_resnet(net_wrap, opt_wrap, loader_fn):
    """resnet50 from seed 0 (f32) on the card, Momentum(1e-3, 0.9),
    through ``Model.fit`` for one epoch of ``loader_fn()``'s batches;
    returns (the batch norms' running buffers after each step, each
    parameter's update in step 1)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision.models import resnet

    pt.seed(0)
    net = resnet.resnet50(num_classes=1000, device="cuda")
    call = net_wrap(net)
    model = pt.Model(call)
    model.prepare(optimizer=opt_wrap(optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=net.parameters())),
        loss=nn.CrossEntropyLoss())
    stats = []
    w0 = {k: v.detach().cpu().clone() for k, v in net.named_parameters()}
    update = {}

    class Stats(Callback):
        def on_train_batch_end(self, step, logs=None):
            stats.append(_dp_bn_stats(net))
            if not update:
                update.update({k: v.detach().cpu() - w0[k]
                               for k, v in net.named_parameters()})

    model.fit(loader_fn(), epochs=1, verbose=0, callbacks=[Stats()])
    del model, call, net
    _dp_free()
    return stats, update


def _dp_sbn(rank, out_dir):
    """(c) resnet50 with ``convert_sync_batchnorm`` at dp=2 through
    fleet and ``Model.fit``: 32 images a rank a step, 2 steps. Then the
    same run with a planted fault, the all-reduce of the statistics
    left out of the backward (each rank's gradient through them its own
    alone), to show that (c)'s limits catch a rank-local backward."""
    import hashlib

    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.collective import fcollectives
    from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
    from paddle_tpu_torch.nn import SyncBatchNorm

    n = DP_SBN_IMAGES
    DS = _dp_resnet_data(n, 224)
    ds = DS(list(range(n)))

    def run():
        return _dp_resnet(
            lambda net: fleet.distributed_model(
                SyncBatchNorm.convert_sync_batchnorm(net)),
            fleet.distributed_optimizer,
            lambda: DataLoader(ds, batch_sampler=DistributedBatchSampler(
                ds, n // 4, num_replicas=2, rank=rank)))

    t0 = time.perf_counter()
    stats, update = run()
    secs = time.perf_counter() - t0
    orig = fcollectives.__dict__["all_reduce"]
    whole = orig.__func__

    def local_backward(x, group=None):
        x0 = x.detach()
        return x + (whole(x0, group) - x0)

    fcollectives.all_reduce = staticmethod(local_backward)
    try:
        fault_stats, fault_update = run()
    finally:
        fcollectives.all_reduce = orig
    h = hashlib.sha256()
    for st in stats:
        for k in sorted(st):
            h.update(st[k].numpy().tobytes())
    if rank == 0:
        torch.save(dict(stats=stats, update=update, fault_stats=fault_stats,
                        fault_update=fault_update),
                   os.path.join(out_dir, "c_runs.pt"))
    return dict(digest=h.hexdigest(), s=secs, buffers=len(stats[-1]),
                steps=len(stats))


def _dp_rank(rank, world, init_file, out_dir):
    """One rank of the dp phase's world: gloo over CUDA tensors on the
    one card, TF32 off."""
    import datetime

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.distributed import (destroy_process_group, fleet,
                                              init_parallel_env)

    init_parallel_env(device="cuda", backend="gloo",
                      init_method=f"file://{init_file}", rank=rank,
                      world_size=world,
                      timeout=datetime.timedelta(seconds=600))
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(),
               device="cuda")
    needs = ("flash_attention_fwd", "flash_attention_bwd")
    res, counts = {}, {}

    def part(key, fn):
        t0 = time.perf_counter()
        out, got = _counted(lambda: fn(rank, out_dir), needs=needs)
        res[key], res[key + "_s"] = out, time.perf_counter() - t0
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v

    part("a", _dp_bert)
    res["a_counts"] = dict(counts)
    part("b", _dp_zero)
    needs = ()
    part("c", _dp_sbn)
    res["counts"] = counts
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    destroy_process_group()


def _dp_world(out):
    """Run the two ranks; returns their records."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(2, os.path.join(out, "init"),
                                             out),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t0 > DP_DEADLINE_S:
                raise AssertionError(f"dp: the rank world outlived "
                                     f"{DP_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _dp_shard_kernels(torch, ident):
    """#2 and #5 at a dp rank's shape of config 2 (BERT-base, 16 rows of
    512, 12 heads of 64, f32, non-causal: the FMA bodies) against their
    plain versions, timed, with SDPA's and the aten backward's times.
    Logged as their own "dp shard" lines."""
    f32 = torch.float32
    rf = check_flash(torch, f32, 16, 512, 12, 64, atol=1e-4, rtol=1e-4,
                     timed=True, causal=False)
    log(_row(f"dp shard flash_attention_fwd f32 B=16 S=512 H=12 D=64 "
             f"non-causal (atol 1e-4 rtol 1e-4; library sdpa) [{ident}]",
             rf))
    rb = check_flash_bwd(torch, f32, 16, 512, 512, 12, 64, timed=True,
                         causal=False)
    log(_row(f"dp shard flash_attention_bwd_fused f32 B=16 S=512 H=12 D=64 "
             f"non-causal (each gradient within 1e-4 of its largest entry; "
             f"library {rb['library']}) [{ident}]", rb))
    return rf, rb


def _dp_reference():
    """The one-process runs the world is held against: (a) BERT-base on
    the whole global batch, its losses and final parameters; (c) resnet50
    on each step's 64 images, with plain batch norms and with batch norms
    that take SyncBatchNorm's arithmetic (E[x^2] - E[x]^2 from the sums)
    with no world, its running buffers and its first update."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.nn import SyncBatchNorm

    _, batch, _ = _dp_cfg()
    init = {}

    def wrap(m, o):
        init.update({k: v.detach().cpu().clone() for k, v in
                     m.state_dict().items()})
        return m, o

    model, _, losses, host, _ = _dp_bert_run(
        list(range(batch)), DP_STEPS, wrap)
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    _dp_free()
    # each reference batch is the union of the ranks' batches of a step
    n = DP_SBN_IMAGES
    q = n // 4
    order = list(np.concatenate([np.arange(q), np.arange(2 * q, 3 * q),
                                 np.arange(q, 2 * q),
                                 np.arange(3 * q, 4 * q)]))
    ds = _dp_resnet_data(n, 224)(order)
    stats, update = _dp_resnet(lambda net: net, lambda o: o,
                               lambda: DataLoader(ds, batch_size=2 * q))

    class OnePass(SyncBatchNorm):
        def forward(self, x):
            return self._summed_norm(x, None) if self.training else \
                super().forward(x)

    one_stats, one_update = _dp_resnet(
        OnePass.convert_sync_batchnorm, lambda o: o,
        lambda: DataLoader(ds, batch_size=2 * q))
    return dict(losses=losses, host=host, params=params, init=init,
                stats=stats, update=update, one_stats=one_stats,
                one_update=one_update)


def _dp_compare(ranks, ref, out):
    """Logs (c)'s readings, then fails unless the world matches the
    one-process runs and its ranks match each other; returns the figures
    to log."""
    import numpy as np
    import torch

    # (c): after step 1 the buffers hold the first batch's statistics
    # alone (the same weights on both sides), so they are held against
    # plain batch norms. Step 1's update and step 2's buffers (the second
    # batch under weights that one update moved) follow SyncBatchNorm's
    # backward; ResNet-50's gradient at init carries rounding far, so
    # they are held against the one-process run of the same arithmetic
    # (OnePass), within DP_SBN_UPDATE_REL and DP_SBN_STEP2_TOL; the plain
    # run's update against OnePass's shows how far rounding alone moves
    # it. The planted fault (the statistics' all-reduce left out of the
    # backward) must land beyond both limits, or they catch nothing.
    c = torch.load(os.path.join(out, "c_runs.pt"))
    bn = _dp_bn_err(c["stats"], ref["stats"])
    sync = dict(update=_dp_update_err(c["update"], ref["one_update"]),
                step2=_dp_bn_err(c["stats"], ref["one_stats"])[-1])
    fault = dict(update=_dp_update_err(c["fault_update"],
                                       ref["one_update"]),
                 step2=_dp_bn_err(c["fault_stats"], ref["one_stats"])[-1])
    plain = _dp_bn_err(ref["one_stats"], ref["stats"])
    plain_update = _dp_update_err(ref["update"], ref["one_update"])
    log(f"dp (c) readings: against plain batch norms, step 1 buffers "
        f"{bn[0][0]:.3g} ({bn[0][1]}), step 2 {bn[-1][0]:.3g} "
        f"({bn[-1][1]}; one process of SyncBatchNorm's arithmetic: "
        f"{plain[0][0]:.3g} / {plain[-1][0]:.3g}); against that one-process "
        f"run: SyncBatchNorm step 1 update {sync['update']:.3g}, step 2 "
        f"buffers {sync['step2'][0]:.3g} ({sync['step2'][1]}); the planted "
        f"rank-local backward: update {fault['update']:.3g}, step 2 buffers "
        f"{fault['step2'][0]:.3g} ({fault['step2'][1]}); plain batch norms' "
        f"update {plain_update:.3g}; limits {DP_SBN_UPDATE_REL} / "
        f"{DP_SBN_STEP2_TOL}")
    a0, a1 = ranks[0]["a"], ranks[1]["a"]
    if a0["digests"] != a1["digests"]:
        raise AssertionError("dp (a): the ranks' parameters differ after "
                             "a step")
    mean = [(x + y) / 2 for x, y in zip(a0["losses"], a1["losses"])]
    lerr = max(abs(m - r) / abs(r) for m, r in zip(mean, ref["losses"]))
    if not lerr <= DP_LOSS_RTOL:
        raise AssertionError(f"dp (a): losses {mean} against one process's "
                             f"{ref['losses']} (rel {lerr:.3g})")
    # (a)'s parameters: the two runs' GEMMs sum in other orders (16 rows
    # against 32), and Adam divides each gradient by its own scale, so an
    # element whose gradient is at rounding level may step +-lr either
    # way (as test_torch_bert.py's key biases): each element within 2 lr
    # a step, and the difference's norm within DP_PARAM_REL of the norm of
    # what the steps moved the parameters
    got = torch.load(os.path.join(out, "a_params.pt"))
    worst, over, diff2, moved2 = ("", 0.0), 0, 0.0, 0.0
    for k, v in ref["params"].items():
        d = (got[k] - v).abs()
        e = float(d.max())
        if e > worst[1]:
            worst = (k, e)
        over += int((d > DP_PARAM_ATOL).sum())
        diff2 += float(d.double().square().sum())
        moved2 += float((v - ref["init"][k]).double().square().sum())
    rel = (diff2 / moved2) ** 0.5
    if worst[1] > 2e-4 * DP_STEPS or not rel <= DP_PARAM_REL:
        raise AssertionError(f"dp (a): parameters off one process's by "
                             f"{worst[1]:.3g} ({worst[0]}), relative norm "
                             f"{rel:.3g}")
    b = ranks[0]["b"]
    for mode in ("os", "os_g", "p_g_os"):
        if not b[mode]["err"] <= DP_PARAM_ATOL:
            raise AssertionError(f"dp (b) {mode}: parameters off dp's by "
                                 f"{b[mode]['err']:.3g}")
        if b[mode]["sharded"] <= 0:
            raise AssertionError(f"dp (b) {mode}: nothing was sharded")
    ck = b["os"].get("ckpt")
    if ck is None or ck["bad"]:
        raise AssertionError(f"dp (d): the two-process checkpoint loaded "
                             f"unequal on rank 0: {ck}")
    if ranks[0]["c"]["digest"] != ranks[1]["c"]["digest"]:
        raise AssertionError("dp (c): the ranks' running statistics differ")
    if not (np.isfinite(bn[0][0]) and bn[0][0] <= DP_BN_TOL):
        raise AssertionError(f"dp (c) step 1: running statistics off the "
                             f"one process's by {bn[0]}")
    for key, val, bad, lim in (
            ("step 1's update", sync["update"], fault["update"],
             DP_SBN_UPDATE_REL),
            ("step 2's buffers", sync["step2"][0], fault["step2"][0],
             DP_SBN_STEP2_TOL)):
        if not (np.isfinite(val) and val <= lim):
            raise AssertionError(f"dp (c): SyncBatchNorm's {key} off one "
                                 f"process's by {val:.3g} (limit {lim})")
        if not bad > lim:
            raise AssertionError(f"dp (c): the planted rank-local backward "
                                 f"moved {key} only {bad:.3g}, within the "
                                 f"limit {lim}: the check catches nothing")
    return dict(mean=mean, lerr=lerr, worst=worst, over=over, rel=rel,
                bn=bn, sync=sync, fault=fault, plain_update=plain_update)


def phase_dp(ident):
    """Data-parallel and sharded training (config 2 at dp=2), as two rank
    processes sharing the one card over gloo (CUDA tensors: NCCL refuses
    two ranks on one device). Every time here is labelled "two ranks
    sharing one H100 over gloo": it is not a dp speed. TF32 off
    throughout.

    First #2 and #5 at a rank's shape (``_dp_shard_kernels``), then the
    one-process references (``_dp_reference``), then one two-rank world
    (``torch.multiprocessing``, a ``file://`` rendezvous), each rank
    ``fleet.init`` (dp=2):

    (a) Config 2: BERT-base f32, seq 512, global batch 32 (16 a rank,
        ``DistributedBatchSampler``), four eager steps through
        ``fleet.distributed_model`` (the model, rank 0's parameters
        broadcast) and ``fleet.distributed_optimizer(AdamW(1e-4,
        grad_clip=ClipGradByGlobalNorm(1.0)))``: the mean of the ranks'
        losses equals one process's on the 32 rows within
        ``DP_LOSS_RTOL``, the parameters after the last step within
        ``DP_PARAM_ATOL`` (key biases 2 lr a step), and the ranks'
        parameters hash alike after every step. Sequences/s, host and
        device ms a step, the all-reduce's share, buckets a step, peak
        memory a rank.
    (b) ZeRO at BERT-base widths, ``DP_ZERO_LAYERS`` layers, two steps:
        dp, then ``group_sharded_parallel`` at ``os``, ``os_g``,
        ``p_g_os`` over both ranks; each level's parameters within
        ``DP_PARAM_ATOL`` of dp's; memory at rest and at peak a rank.
    (c) ``resnet50`` with ``SyncBatchNorm.convert_sync_batchnorm`` at dp=2
        through ``Model.fit``, 32 images a rank, two steps: the running
        statistics after step 1 equal one process's plain batch norms on
        the step's 64 images within ``DP_BN_TOL`` of each buffer's largest
        entry; step 1's update and step 2's statistics equal one process
        of SyncBatchNorm's arithmetic on the same images within
        ``DP_SBN_UPDATE_REL`` and ``DP_SBN_STEP2_TOL``, which a planted
        rank-local backward exceeds (see ``_dp_compare``); both ranks'
        hash alike.
    (d) (b)'s ``os`` model and optimizer saved by both ranks
        (``save_state_dict(..., group=)``: each rank's slices and marker)
        and loaded by rank 0 alone: bitwise the gathered state.

    Returns the launches by kernel row, both ranks' summed."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = tempfile.mkdtemp(prefix="dp_phase_")
    try:
        _dp_shard_kernels(torch, ident)
        t0 = time.perf_counter()
        ref = _dp_reference()
        ref_s = time.perf_counter() - t0
        _dp_free()
        log(f"dp: this process holds "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the "
            f"card while the ranks run")
        t0 = time.perf_counter()
        ranks = _dp_world(out)
        world_s = time.perf_counter() - t0
        fig = _dp_compare(ranks, ref, out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(out, ignore_errors=True)
    a0, a1 = ranks[0]["a"], ranks[1]["a"]
    _, batch, seq = _dp_cfg()
    step_s = statistics.mean(a0["host"][1:])
    ref_step = statistics.mean(ref["host"][1:])
    log(f"dp (a) BERT-base f32 seq {seq} global batch {batch} at dp=2 "
        f"({DP_LABEL}), {DP_STEPS} steps through distributed_model + "
        f"distributed_optimizer(AdamW, ClipGradByGlobalNorm(1.0)): mean "
        f"losses {[round(v, 6) for v in fig['mean']]} against one "
        f"process's {[round(v, 6) for v in ref['losses']]} (worst rel "
        f"{fig['lerr']:.3g}, limit {DP_LOSS_RTOL}); final parameters: "
        f"worst {fig['worst'][1]:.3g} ({fig['worst'][0]}), {fig['over']} "
        f"elements beyond {DP_PARAM_ATOL}, the difference's norm "
        f"{fig['rel']:.3g} of the steps' movement (limit {DP_PARAM_REL}); "
        f"the ranks' "
        f"parameters hash alike after all {DP_STEPS} steps [{ident}]")
    def share(a):  # steps 2 on: the first also loads and tunes
        return sum(a["reduce_s"][1:]) / sum(a["host"][1:])

    log(f"dp (a): {batch / step_s:.2f} sequences/s ({batch * seq / step_s:.0f}"
        f" tokens/s; one process on the card {batch / ref_step:.2f}); a "
        f"step {1e3 * step_s:.1f} ms host (steps 2-{DP_STEPS}: "
        f"{[round(1e3 * v, 1) for v in a0['host'][1:]]}), device "
        f"{statistics.mean(a0['dev'][1:]):.1f} ms (CUDA events, the "
        f"stream's waits included); the all-reduce ms a step "
        f"{[round(1e3 * v, 1) for v in a0['reduce_s'][1:]]} = "
        f"{share(a0):.1%} of steps 2-{DP_STEPS} (rank 1 {share(a1):.1%}), "
        f"{a0['reduce_calls']} calls, buckets a step {a0['buckets']}; step "
        f"1 {1e3 * a0['host'][0]:.0f} ms; peak GiB rank 0 "
        f"{a0['peak_gib']:.2f} rank 1 {a1['peak_gib']:.2f}; flash launches "
        f"rank 0 {ranks[0]['a_counts'].get('flash_attention_fwd')} forward "
        f"{ranks[0]['a_counts'].get('flash_attention_bwd')} backward "
        f"[{ident}]")
    b = ranks[0]["b"]
    log(f"dp (b) ZeRO at BERT-base widths, {DP_ZERO_LAYERS} of 12 layers, "
        f"{DP_ZERO_STEPS} steps, sharding=2 ({DP_LABEL}): parameters off "
        f"dp's by os {b['os']['err']:.3g}, os_g {b['os_g']['err']:.3g}, "
        f"p_g_os {b['p_g_os']['err']:.3g} (limit {DP_PARAM_ATOL}); GiB a "
        f"rank at rest / peak: "
        + ", ".join(f"{m} {b[m]['rest_gib']:.3f} / {b[m]['peak_gib']:.2f}"
                    for m in ("dp", "os", "os_g", "p_g_os"))
        + f"; ms a step (host) "
        + ", ".join(f"{m} {1e3 * statistics.mean(b[m]['host'][1:]):.1f}"
                    for m in ("dp", "os", "os_g", "p_g_os"))
        + f" [{ident}]")
    ck = b["os"]["ckpt"]
    sync, fault = fig["sync"], fig["fault"]
    log(f"dp (c) resnet50 SyncBatchNorm at dp=2 through Model.fit, 32 "
        f"images a rank, 2 steps: {ranks[0]['c']['buffers']} running "
        f"buffers after step 1 against one process's plain batch norms over "
        f"the 64 images {fig['bn'][0][0]:.3g} of the largest entry (limit "
        f"{DP_BN_TOL}); against one process of SyncBatchNorm's arithmetic, "
        f"step 1's update {sync['update']:.3g} and step 2's buffers "
        f"{sync['step2'][0]:.3g} (limits {DP_SBN_UPDATE_REL} and "
        f"{DP_SBN_STEP2_TOL}; a planted rank-local backward: "
        f"{fault['update']:.3g} and {fault['step2'][0]:.3g}; plain batch "
        f"norms' update {fig['plain_update']:.3g}), both ranks' alike; (d) "
        f"the os "
        f"state saved by both ranks ({ck['tensors']} tensors, "
        f"{ck['bytes'] / 2**20:.1f} MiB, "
        f"save {b['os']['save_s']:.2f} s) loaded on rank 0 alone in "
        f"{b['os']['load_s']:.2f} s: bitwise the gathered state [{ident}]")
    counts = {}
    for r in ranks:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    log(f"dp: references {ref_s:.1f} s; world {world_s:.1f} s (parts "
        f"(a) {ranks[0]['a_s']:.1f} (b) {ranks[0]['b_s']:.1f} (c) "
        f"{ranks[0]['c_s']:.1f}); launches both ranks "
        f"{({k: v for k, v in counts.items() if v})}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": counts.get("flash_attention_fwd", 0),
            "flash_attention_bwd_fused": counts.get("flash_attention_bwd",
                                                    0)}


# ------------------------------------------------------------ phase pp
PP_DEADLINE_S = 600   # the rank world's wall clock, as a hang guard
PP_LAYERS = 4         # config 4's blocks, of 32: two a stage
PP_DIMS = (4096, 32, 50304)  # hidden, heads, vocab (config 4)
PP_SEQ, PP_BATCH, PP_MICRO, PP_STEPS = 2048, 8, 4, 2
PP_LR = 1e-4
PP_LOSS_RTOL = 1e-5   # f32 sums in another order (the dp phase's limit)
PP_PARAM_REL = 1e-3   # the dp phase's rule (see _dp_compare)
PP_LABEL = "four ranks sharing one H100 over gloo: not a pipeline speed"


class _PPWeights(dict):
    """The weights of config 4's pipeline model by global name, drawn on
    the card from a seed a name (so the one-process reference and every
    rank draw the same values without a host copy): matrices N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.02), biases N(0, 0.02). ``shapes``: the
    whole model's ``{name: shape}``."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = dict(shapes)

    def __contains__(self, name):
        return name in self.shapes

    def __missing__(self, name):
        import hashlib

        import torch

        seed = int(hashlib.sha256(name.encode()).hexdigest()[:12], 16)
        g = torch.Generator(device="cuda").manual_seed(seed)
        shape = tuple(self.shapes[name])
        t = 0.02 * torch.randn(shape, generator=g, device="cuda")
        if len(shape) == 1 and "ln" in name and name.endswith("weight"):
            t += 1.0
        return t


def _pp_decay(named):
    """The reference pipeline's weight-decay rule by name: matrices."""
    decay = {n for n, p in named if p.dim() > 1}
    return lambda name: name in decay


def _pp_batches():
    import numpy as np

    ex = _example("pretrain_gpt_hybrid_torch")
    rng = np.random.default_rng(0)
    return [ex.global_batch(rng, PP_DIMS[2], PP_BATCH, PP_SEQ)
            for _ in range(PP_STEPS)]


def _pp_reference(out):
    """Config 4's 4-layer model in this process, unpipelined (no world:
    every stage, mp = 1), on the same weights and batches: each step the
    four microbatches' gradients accumulated (each loss over 4), then
    AdamW(1e-4) with ClipGradByGlobalNorm(1.0) and the pipeline's decay
    rule. Saves the final parameters to ``out``; returns the losses, the
    step times and the shapes."""
    import torch

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer

    ex = _example("pretrain_gpt_hybrid_torch")
    hidden, heads, vocab = PP_DIMS
    model = PipelineLayer(ex.build_layers(hidden, heads, PP_LAYERS, vocab),
                          num_stages=1, loss_fn=ex.ce_loss, device="cuda")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    pipeline_stage_from_numpy(model, _PPWeights(shapes))
    named = list(model.named_parameters())
    opt = optimizer.AdamW(learning_rate=PP_LR, parameters=named,
                          apply_decay_param_fun=_pp_decay(named),
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    losses, host = [], []
    for ids, labels in _pp_batches():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = torch.from_numpy(ids).cuda().split(PP_BATCH // PP_MICRO)
        labels = torch.from_numpy(labels).cuda().split(PP_BATCH // PP_MICRO)
        total = 0.0
        for x, y in zip(ids, labels):
            loss = ex.ce_loss(model(x), y)
            (loss / PP_MICRO).backward()
            total += float(loss.detach())
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        losses.append(total / PP_MICRO)
    torch.save({n: p.detach().cpu() for n, p in named},
               os.path.join(out, "ref_params.pt"))
    n_params = sum(p.numel() for _, p in named)
    del model, opt, named
    _dp_free()
    return dict(losses=losses, host=host, shapes=shapes, n_params=n_params)


def _pp_timed_mp(group):
    """Time the collectives over ``group`` (the mp group): the device is
    synchronised first, then the host wall of each gloo call. Returns (the
    totals, a function that restores torch.distributed's calls)."""
    import torch
    import torch.distributed as dist

    tot = {"s": 0.0, "calls": 0}
    saved = {}
    for name in ("all_reduce", "all_gather", "broadcast"):
        orig = getattr(dist, name)
        saved[name] = orig

        def timed(*a, _orig=orig, **k):
            if k.get("group") is not group.process_group:
                return _orig(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            tot["s"] += time.perf_counter() - t0
            tot["calls"] += 1
            return out

        setattr(dist, name, timed)
    return tot, lambda: [setattr(dist, k, v) for k, v in saved.items()]


def _pp_rank(rank, world, init_file, out_dir, shapes):
    """One rank of the pp world: gloo over CUDA tensors on the one card,
    TF32 off; config 4's stage through fleet, two steps of train_batch."""
    import datetime
    import hashlib

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import nn, optimizer, profiler
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed import (destroy_process_group, fleet,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer

    init_parallel_env(device="cuda", backend="gloo",
                      init_method=f"file://{init_file}", rank=rank,
                      world_size=world,
                      timeout=datetime.timedelta(seconds=PP_DEADLINE_S))
    ex = _example("pretrain_gpt_hybrid_torch")
    hidden, heads, vocab = PP_DIMS
    t0 = time.perf_counter()
    fleet.init(is_collective=True,
               strategy=ex.strategy_for(dict(mp=2, pp=2, sharding=1),
                                        PP_MICRO, False), device="cuda")
    hcg = fleet.get_hybrid_communicate_group()
    model = PipelineLayer(ex.build_layers(hidden, heads, PP_LAYERS, vocab),
                          num_stages=2, loss_fn=ex.ce_loss)
    pipeline_stage_from_numpy(model, _PPWeights(shapes))
    engine = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=PP_LR, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = ex.model_params(model, hcg)
    tot, restore = _pp_timed_mp(hcg.get_model_parallel_group())
    torch.cuda.reset_peak_memory_stats()
    rec = dict(losses=[], host=[], p2p=[], mp=[], stats=[])

    def steps():
        for ids, labels in _pp_batches():
            torch.cuda.synchronize()
            before = tot["s"]
            t1 = time.perf_counter()
            loss = engine.train_batch([torch.from_numpy(ids),
                                       torch.from_numpy(labels)], opt)
            torch.cuda.synchronize()
            rec["host"].append(time.perf_counter() - t1)
            rec["losses"].append(float(loss))
            rec["p2p"].append(engine.last_stats["p2p_s"])
            rec["mp"].append(tot["s"] - before)
            rec["stats"].append(dict(engine.last_stats))

    try:
        _, counts = _counted(steps, needs=("flash_attention_fwd",
                                           "flash_attention_bwd"))
    finally:
        restore()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["counts"] = counts
    tps = PP_BATCH * PP_SEQ / statistics.mean(rec["host"][1:] or
                                              rec["host"])
    rec["mfu"] = profiler.mfu(n_params, tps,
                              peak_flops_per_chip=F32_FLOPS_PER_S)
    rec.update(n_params=n_params, build_s=build_s,
               coords=dict(pp=hcg.get_stage_id(),
                           mp=hcg.get_model_parallel_rank()))
    # the replicated parameters' digest (the mp ranks of a stage must
    # agree), and this rank's parameters against the reference's
    h = hashlib.sha256()
    for n, p in sorted(model.named_parameters()):
        if getattr(p, "is_distributed", False) is not True:
            h.update(p.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
    rec["digest"] = h.hexdigest()
    ref = torch.load(os.path.join(out_dir, "ref_params.pt"), mmap=True)
    init = _PPWeights(shapes)
    mp_group = hcg.get_model_parallel_group()
    from paddle_tpu_torch.convert import shard_state_dict

    worst, diff2, moved2 = ("", 0.0), 0.0, 0.0
    for n, p in model.named_parameters():
        if getattr(p, "is_distributed", False) is not True and \
                mp_group.rank != 0:
            continue  # a replicated parameter: counted on mp rank 0
        want = shard_state_dict({n: ref[n]}, model=model,
                                mp=mp_group.nranks,
                                mp_rank=mp_group.rank)[n].cuda()
        start = shard_state_dict({n: init[n]}, model=model,
                                 mp=mp_group.nranks,
                                 mp_rank=mp_group.rank)[n]
        d = (p.detach() - want).abs()
        e = float(d.max())
        if e > worst[1]:
            worst = (n, e)
        diff2 += float(d.double().square().sum())
        moved2 += float((want - start).double().square().sum())
    rec.update(worst=worst, diff2=diff2, moved2=moved2)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    destroy_process_group()


def _pp_world(out, shapes):
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(_pp_rank, args=(4, os.path.join(out, "init"),
                                             out, shapes),
                             nprocs=4, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t0 > PP_DEADLINE_S:
                raise AssertionError(f"pp: the rank world outlived "
                                     f"{PP_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]


def phase_pp(ident):
    """Pipeline parallelism and config 4 (``examples/pretrain_gpt_hybrid
    _torch.py``'s path) at pp 2 x mp 2, as four rank processes sharing the
    one card over gloo (CUDA tensors; the point-to-point sends go through
    host buffers). Every time here is labelled "four ranks sharing one H100
    over gloo: not a pipeline speed". TF32 off throughout.

    First #2 and the flash backward at a rank's shape of config 4 (f32,
    a microbatch of 2 x 2048, 16 heads of 128, causal: the FMA bodies)
    against their plain versions. Then the one-process reference
    (``_pp_reference``): config 4's widths (hidden 4096, 32 heads, vocab
    50304) at 4 of 32 layers, the same four microbatches accumulated, then
    AdamW and the clip; its memory freed. Then one four-rank world, each
    rank ``fleet.init`` (mp 2 x pp 2), its stage of ``build_layers`` (two
    blocks, the embedding or the head) filled by
    ``convert.pipeline_stage_from_numpy``, ``fleet.distributed_model`` (a
    ``PipelineParallel``) and ``distributed_optimizer(AdamW(1e-4,
    ClipGradByGlobalNorm(1.0)))``, two steps of ``train_batch`` on the
    global batch of 8 x 2048 in 4 microbatches (1F1B, recompute).

    Checks: every rank's loss of each step equal, and within
    ``PP_LOSS_RTOL`` of the one process's; the parameters after step 2
    within 2 lr a step elementwise and the difference's norm within
    ``PP_PARAM_REL`` of the steps' movement (the dp phase's rule); the two
    mp ranks of a stage hash their replicated parameters alike. Logs ms a
    step, tokens/s, the point-to-point and mp-collective shares, peak
    memory a rank, ``profiler.mfu`` against the f32 peak, and the flash
    launches, which it returns (all four ranks summed)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = tempfile.mkdtemp(prefix="pp_phase_")
    try:
        f32 = torch.float32
        rf = check_flash(torch, f32, 2, PP_SEQ, 16, 128, atol=1e-4,
                         rtol=1e-4, timed=True)
        log(_row(f"pp shard flash_attention_fwd f32 B=2 S={PP_SEQ} H=16 "
                 f"D=128 causal (atol 1e-4 rtol 1e-4; library sdpa) "
                 f"[{ident}]", rf))
        rb = check_flash_bwd(torch, f32, 2, PP_SEQ, PP_SEQ, 16, 128,
                             timed=True)
        log(_row(f"pp shard flash_attention_bwd_fused f32 B=2 S={PP_SEQ} "
                 f"H=16 D=128 causal (each gradient within 1e-4 of its "
                 f"largest entry; library {rb['library']}) [{ident}]", rb))
        t0 = time.perf_counter()
        ref = _pp_reference(out)
        ref_s = time.perf_counter() - t0
        log(f"pp: this process holds "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card "
            f"while the ranks run")
        t0 = time.perf_counter()
        ranks = _pp_world(out, ref["shapes"])
        world_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(out, ignore_errors=True)
    for step in range(PP_STEPS):
        vals = {r["losses"][step] for r in ranks}
        if len(vals) != 1:
            raise AssertionError(f"pp: the ranks' step {step + 1} losses "
                                 f"differ: {sorted(vals)}")
    lerr = max(abs(a - b) / abs(b) for a, b in
               zip(ranks[0]["losses"], ref["losses"]))
    diff2 = sum(r["diff2"] for r in ranks)
    moved2 = sum(r["moved2"] for r in ranks)
    rel = (diff2 / moved2) ** 0.5
    worst = max((r["worst"] for r in ranks), key=lambda w: w[1])
    by = {(r["coords"]["pp"], r["coords"]["mp"]): r for r in ranks}
    log(f"pp config 4 at pp 2 x mp 2 ({PP_LABEL}): hidden {PP_DIMS[0]}, "
        f"{PP_DIMS[1]} heads, vocab {PP_DIMS[2]}, {PP_LAYERS} of 32 layers, "
        f"{ranks[0]['n_params'] / 1e9:.3f} B parameters (one process "
        f"{ref['n_params'] / 1e9:.3f} B), global batch {PP_BATCH} x "
        f"{PP_SEQ} in {PP_MICRO} microbatches, 1F1B with recompute: losses "
        f"{[round(v, 6) for v in ranks[0]['losses']]} on every rank against "
        f"one process's {[round(v, 6) for v in ref['losses']]} (worst rel "
        f"{lerr:.3g}, limit {PP_LOSS_RTOL}); parameters after step "
        f"{PP_STEPS}: worst {worst[1]:.3g} ({worst[0]}), the difference's "
        f"norm {rel:.3g} of the steps' movement (limit {PP_PARAM_REL}); the "
        f"mp ranks' replicated parameters hash alike: "
        f"{all(by[(s, 0)]['digest'] == by[(s, 1)]['digest'] for s in (0, 1))}"
        f" [{ident}]")
    for s in (0, 1):
        if by[(s, 0)]["digest"] != by[(s, 1)]["digest"]:
            raise AssertionError(f"pp: stage {s}'s mp ranks hold different "
                                 f"replicated parameters")
    if not lerr <= PP_LOSS_RTOL:
        raise AssertionError(f"pp: losses off one process's by {lerr:.3g}")
    if worst[1] > 2 * PP_LR * PP_STEPS or not rel <= PP_PARAM_REL:
        raise AssertionError(f"pp: parameters off one process's by "
                             f"{worst[1]:.3g} ({worst[0]}), relative norm "
                             f"{rel:.3g}")
    step_s = [statistics.mean(r["host"][1:]) for r in ranks]
    tok = PP_BATCH * PP_SEQ
    parts = []
    for r in ranks:
        h = sum(r["host"][1:])
        parts.append(f"stage {r['coords']['pp']} mp {r['coords']['mp']}: "
                     f"p2p {1e3 * statistics.mean(r['p2p'][1:]):.0f} ms "
                     f"({sum(r['p2p'][1:]) / h:.1%}), mp collectives "
                     f"{1e3 * statistics.mean(r['mp'][1:]):.0f} ms "
                     f"({sum(r['mp'][1:]) / h:.1%}), peak "
                     f"{r['peak_gib']:.2f} GiB")
    counts = {}
    for r in ranks:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    log(f"pp: a step {1e3 * max(step_s):.0f} ms host (step 2; step 1 "
        f"{1e3 * max(r['host'][0] for r in ranks):.0f} ms, of it p2p "
        f"{1e3 * max(r['p2p'][0] for r in ranks):.0f} and mp collectives "
        f"{1e3 * max(r['mp'][0] for r in ranks):.0f}), "
        f"{tok / max(step_s):.0f} tokens/s (one process on the card "
        f"{tok / statistics.mean(ref['host'][1:]):.0f}); "
        + "; ".join(parts)
        + f"; profiler.mfu against the f32 peak {F32_FLOPS_PER_S / 1e12:.0f} "
        f"TF/s: {ranks[0]['mfu']:.4f} (6 N a token, recomputation not "
        f"counted; the card's tokens/s); flash launches forward "
        f"{counts.get('flash_attention_fwd')} backward "
        f"{counts.get('flash_attention_bwd')} (four ranks) [{ident}]")
    log(f"pp: reference {ref_s:.1f} s; world {world_s:.1f} s (build "
        f"{max(r['build_s'] for r in ranks):.1f} s a rank); phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": counts.get("flash_attention_fwd", 0),
            "flash_attention_bwd_fused": counts.get("flash_attention_bwd",
                                                    0)}


def phase_ncclprobe(ident):
    """Opt-in: two NCCL ranks on the one card (the tp phase's layout) do
    one all-reduce in a subprocess world, bounded to 120 s; logs what NCCL
    says (it refuses two ranks on one device, which is why the tp phase
    runs gloo)."""
    import tempfile

    code = (
        "import os, sys, torch, torch.distributed as dist\n"
        "import torch.multiprocessing as mp\n"
        "def run(rank, path):\n"
        "    torch.cuda.set_device(0)\n"
        "    dist.init_process_group('nccl', init_method='file://' + path,\n"
        "                            rank=rank, world_size=2)\n"
        "    t = torch.ones(4, device='cuda')\n"
        "    dist.all_reduce(t)\n"
        "    torch.cuda.synchronize()\n"
        "    print('rank', rank, 'all_reduce', t.tolist(), flush=True)\n"
        "    dist.destroy_process_group()\n"
        "if __name__ == '__main__':\n"
        "    mp.start_processes(run, args=(sys.argv[1],), nprocs=2,\n"
        "                       start_method='spawn')\n")
    tmp = tempfile.mkdtemp(prefix="ncclprobe_")
    script = os.path.join(tmp, "probe.py")
    with open(script, "w") as f:
        f.write(code)
    try:
        out = subprocess.run([sys.executable, script,
                              os.path.join(tmp, "init")],
                             capture_output=True, text=True, timeout=120)
        text = out.stdout + out.stderr
        said = [ln.strip() for ln in text.splitlines()
                if "uplicate" in ln or "all_reduce" in ln
                or "Error" in ln or "error" in ln]
        log(f"ncclprobe: exit {out.returncode}; "
            + " | ".join(said)[:1500] + f" [{ident}]")
    except subprocess.TimeoutExpired:
        log(f"ncclprobe: the two NCCL ranks on one card hung past 120 s "
            f"(killed) [{ident}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + OPTIONAL_PHASES))
    ap.add_argument("--resnet-child", help=argparse.SUPPRESS)
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
    if args.resnet_child:
        return _resnet_child(json.loads(args.resnet_child))
    ident = gpu_identity()
    log(f"card: {ident}")
    kernel_stats, launches, took = {}, {}, {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        took[phase] = round(time.perf_counter() - t0, 1)
        return out

    t_run = time.perf_counter()
    children = None
    if "build" in phases and "resnet" in phases:
        # the resnet phase's children (bitwise resume, the fault points)
        # need no kernel of csrc/: they run beside nvcc, and the card is
        # theirs alone until they end
        children = _ResnetChildren(str(_resnet_root()))
    try:
        if "build" in phases:
            timed("build", phase_build)
        if children is not None:
            timed("resnet children", children.result)
    finally:
        if children is not None:
            children.stop()
    if "kernels" in phases:
        kernel_stats = timed("kernels", phase_kernels)
    if "context" in phases:
        stats, n = timed("context", phase_context, ident)
        kernel_stats.update(stats)
        launches.update(n)
    for phase, run in (("main", phase_main), ("serve", phase_serve),
                       ("generate", phase_generate), ("tier", phase_tier),
                       ("cluster", phase_cluster), ("draft", phase_draft),
                       ("fused", phase_fused), ("bert", phase_bert),
                       ("export", phase_export),
                       ("moe_train", phase_moe_train), ("tp", phase_tp),
                       ("dp", phase_dp), ("pp", phase_pp)):
        if phase in phases:
            for name, n in timed(phase, run, ident).items():
                launches[name] = launches.get(name, 0) + n
    for phase, run in (("greedy", phase_greedy),
                       ("resnet", lambda i: phase_resnet(i, children)),
                       ("profile", phase_profile), ("drift", phase_drift),
                       ("anatomy", phase_anatomy), ("sched", phase_sched),
                       ("loadgen", phase_loadgen),
                       ("draftcause", phase_draftcause),
                       ("ncclprobe", phase_ncclprobe)):
        if phase in phases:
            timed(phase, run, ident)
    log(f"phase seconds: {json.dumps(took)}; all phases "
        f"{time.perf_counter() - t_run:.1f} s")
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
    for name, before in FMA_BEFORE.items():
        ms = kernel_stats.get(name, {}).get("ms")
        if ms:
            log(f"flash row {name}: {ms:.4f} ms (the FMA-only kernel, an "
                f"earlier run: {before:.4f} ms, {before / ms:.1f}x)")
    log("kernels: " + ", ".join(KERNELS))
    log(f"card: {ident}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _check_done(reqs, items):
    """Fail unless every request finished with its full budget."""
    for r, (p, m, t, _s) in zip(reqs, items):
        if r.failed or not r.done or len(r.tokens) != m:
            raise AssertionError(
                f"request {r.rid} (prompt {len(p)}, temp {t}) ended "
                f"{r.state} reason={r.failure_reason} with "
                f"{len(r.tokens)}/{m} tokens")


def _no_caught_fault(eng, tag):
    """A fault the engine caught still fails the run. ``step`` recovers
    from a failed dispatch (every request requeues and recomputes on the
    same kernels) and the spec step drafts nothing when its drafter raises;
    either can leave every stream right all the same, so each Engine pass
    ends here. Fails if ``eng`` recovered a step (a failed graph capture
    or replay among them), lost a draft to a drafter fault or was
    quarantined, or, unless the pass turned its graphs off, if a decode
    chain or verify step of the pass ran other than as a CUDA graph."""
    wd = eng._watchdog
    drafter = eng._spec.drafter_faults if eng._spec is not None else 0
    if wd.last_fault is not None or wd.quarantined or drafter:
        raise AssertionError(
            f"{tag}: the engine caught a fault: step fault "
            f"{wd.last_fault!r}, {drafter} drafter faults, quarantined "
            f"{wd.quarantined}")
    graphs = eng.runner._graphs
    if graphs.enabled and any(st.graph is None
                              for st in graphs.steps.values()):
        raise AssertionError(f"{tag}: a step ran eagerly with graphs on")


def _graph_note(eng):
    """The captured steps of ``eng``: how many, their capture ms, the
    graph pool's bytes."""
    steps = [st for st in eng.runner._graphs.steps.values()
             if st.graph is not None]
    pool = _pool_bytes(eng.runner._graphs)
    return (f"{len(steps)} graphs, capture "
            f"{sum(st.capture_ms for st in steps):.1f} ms, pool "
            + ("not measured" if pool is None else f"{pool} bytes"))


def _pool_bytes(graphs):
    """Bytes of the segments of ``graphs``'s private memory pool
    (``torch.cuda.memory_snapshot``), or None where the snapshot does not
    name its segments' pool."""
    import torch

    if graphs._pool is None:
        return 0
    want = tuple(graphs._pool)
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if tuple(pid) == want:
            total += seg["total_size"]
    return total if named else None


def _serve_items(engine, items, tag="engine pass"):
    """Queue ``items`` [(prompt, new_tokens, temperature, seed)] and run the
    engine to completion; fail unless every request finished with its full
    budget and the engine caught no fault. Returns (requests, wall
    seconds)."""
    import torch

    reqs = [engine.add_request(p, m, temperature=t, seed=s)
            for p, m, t, s in items]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_done(reqs, items)
    _no_caught_fault(engine, tag)
    return reqs, wall


def _serve(engine, specs, rng, vocab):
    """``_serve_items`` over random prompts: ``specs`` [(prompt_len,
    new_tokens, temperature, seed)]."""
    return _serve_items(engine, [(rng.integers(0, vocab, (n,)), m, t, s)
                                 for n, m, t, s in specs])


def _sched_probe(eng):
    """Instrument ``eng``'s scheduler (instance attributes over its
    methods): the requests its pre-admission waves take, its steps and
    their host wall, its chains by depth, and the disaggregated steps that
    ran both roles. Returns the dict it fills."""
    note = {"preadmitted": [], "steps": 0, "step_s": 0.0, "depths": {},
            "both_roles": 0, "disagg_steps": 0}
    roles = set()
    preadmit, chain, mixed = (eng._preadmit_dispatch, eng._chain_dispatch,
                              eng._mixed_dispatch)
    step, disagg = eng.step, eng._disagg_step

    def preadmit_w(k, exclude=()):
        out = preadmit(k, exclude)
        note["preadmitted"] += [r.rid for r, *_ in out[0]]
        return out

    def chain_w(slots, k, budget, *a):
        roles.add("chain")
        note["depths"][k] = note["depths"].get(k, 0) + budget
        return chain(slots, k, budget, *a)

    def mixed_w(slots):
        roles.add("mixed")
        return mixed(slots)

    def disagg_w():
        roles.clear()
        disagg()
        note["disagg_steps"] += 1
        note["both_roles"] += roles == {"chain", "mixed"}

    def step_w(n=None):
        t0 = time.perf_counter()
        out = step(n)
        note["step_s"] += time.perf_counter() - t0
        note["steps"] += 1
        return out

    eng._preadmit_dispatch, eng._chain_dispatch = preadmit_w, chain_w
    eng._mixed_dispatch, eng._disagg_step, eng.step = (mixed_w, disagg_w,
                                                       step_w)
    return note


def _sched_line(eng, note):
    """The scheduler's record of one pass, as one log fragment."""
    ratio = eng._dispatch_ratio
    cost = (f"pinned {eng._cost_pin}" if eng._cost_pin is not None else
            "the prior 8.0 throughout" if ratio is None else
            f"measured {ratio!r} chunks")
    return (f"{len(note['preadmitted'])} pre-admitted (rids "
            f"{note['preadmitted']}), {note['steps']} steps, chains by "
            f"depth {dict(sorted(note['depths'].items()))}, boundary cost "
            f"{cost}, {2 - eng._probe_budget} probes, {eng._chain_obs} "
            "samples")


def _at_prior(eng):
    """Whether every chain depth ``eng`` chose used the prior boundary cost
    (no probe, no measured ratio): its schedule is a pinned run's."""
    return eng._dispatch_ratio is None and eng._probe_budget == 2


def _device_busy_ms(prof):
    """The device time of every CUDA event (kernels, copies, fills) under
    ``prof``, summed from the raw trace: a whole engine pass replays
    ~10^6 kernels, which ``key_averages()`` takes minutes to tabulate."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()
               ) / 1e6


def _report(tag, reqs, wall, ident):
    """Log and return (tok/s, median TTFT ms) of a finished pass."""
    ttft = sorted((r._t_first - r._t_arrival) * 1e3 for r in reqs)
    toks = sum(len(r.tokens) for r in reqs)
    log(f"{tag}: {len(reqs)} requests, {toks} tokens in {wall:.3f} s = "
        f"{toks / wall:.1f} tok/s; TTFT ms median "
        f"{statistics.median(ttft):.1f} max {ttft[-1]:.1f} [{ident}]")
    return toks / wall, statistics.median(ttft)


def _counters():
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    # name -> (wrapper, its counter); the flash wrappers' ``launches``
    # include their position-mode launches, which ``pos_launches`` counts,
    # and their tensor-core launches, which ``tc_launches`` counts; the
    # verify and quant wrappers' include their tensor-core launches
    # (``tc_launches``) and the grouped matmul's its wgmma launches
    # (``wgmma_launches``)
    return {"paged_decode_attention": (pa.paged_slab_decode_attention,
                                       "launches"),
            "flash_attention_fwd": (fa.flash_attention_fwd, "launches"),
            "flash_attention_bwd": (fa.flash_attention_bwd, "launches"),
            "flash_attention_fwd_tc": (fa.flash_attention_fwd,
                                       "tc_launches"),
            "flash_attention_bwd_tc": (fa.flash_attention_bwd,
                                       "tc_launches"),
            "flash_attention_fwd_pos": (fa.flash_attention_fwd,
                                        "pos_launches"),
            "flash_attention_bwd_pos": (fa.flash_attention_bwd,
                                        "pos_launches"),
            "paged_verify_attention": (pa.paged_verify_slab_attention,
                                       "launches"),
            "paged_verify_attention_tc": (pa.paged_verify_slab_attention,
                                          "tc_launches"),
            "quant_matmul": (qm.quant_matmul, "launches"),
            "quant_matmul_tc": (qm.quant_matmul, "tc_launches"),
            "grouped_matmul": (gm.grouped_matmul, "launches"),
            "grouped_matmul_wgmma": (gm.grouped_matmul, "wgmma_launches"),
            "paged_decode_attention_v1": (pa.paged_decode_attention,
                                          "launches"),
            "decode_attention": (da.decode_attention, "launches"),
            "decode_attention_slab": (da.decode_attention_slab, "launches")}


def _counted(run, needs=(), tc=None):
    """Zero every launch counter, ``run()``, read the counters. Fails if a
    kernel in ``needs`` was never launched. ``tc``, the tag of a pass whose
    attention is bf16 at head dim 64 or 128 throughout: logs the flash
    wrappers', the verify wrapper's and the quant matmul's tensor-core
    launches and fails unless every flash, verify and quant launch of the
    pass was one (such a pass runs its quantized Linears on bf16 x). Logs
    the grouped matmul's wgmma launches where it ran. Returns (run's
    result, launches without the tensor-core and wgmma counts)."""
    fns = _counters()
    for fn, attr in fns.values():
        setattr(fn, attr, 0)
    out = run()
    got = {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}
    for name in needs:
        if got[name] <= 0:
            raise AssertionError(f"this pass never launched {name}")
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    on_tc = {name: got.pop(name + "_tc")
             for name in flash + ("paged_verify_attention", "quant_matmul")}
    wgmma = got.pop("grouped_matmul_wgmma")
    if tc is not None:
        log(f"{tc}: tensor-core flash launches: forward "
            f"{on_tc[flash[0]]} of {got[flash[0]]}, backward "
            f"{on_tc[flash[1]]} of {got[flash[1]]}")
        if got["paged_verify_attention"]:
            log(f"{tc}: tensor-core verify launches: "
                f"tc_launches {on_tc['paged_verify_attention']} of launches "
                f"{got['paged_verify_attention']}")
        if got["quant_matmul"]:
            log(f"{tc}: tensor-core quant matmul launches: tc_launches "
                f"{on_tc['quant_matmul']} of launches {got['quant_matmul']}"
                f" (tc_launches == launches: "
                f"{on_tc['quant_matmul'] == got['quant_matmul']})")
        for name in on_tc:
            if on_tc[name] != got[name]:
                raise AssertionError(f"{tc}: {got[name] - on_tc[name]} bf16 "
                                     f"launches of {name} left the "
                                     "tensor-core body")
    if got["grouped_matmul"]:
        log(f"{tc or 'pass'}: grouped matmul launches "
            f"{got['grouped_matmul']}, wgmma_launches {wgmma}")
    return out, got


def phase_main(ident):
    """llama2_7b at full width and depth, bf16, through the Engine: three
    vanilla passes, then one pass in each mode that rides the verify
    kernel; pass A with int8 and int4 weights; pass B a Mixtral-width MoE
    at 16 layers; then the training passes (``train_passes``). Launches
    are counted per pass and summed into the rows of ``KERNELS``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    cfg = llama2_7b()
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main: llama2_7b {cfg.num_params() / 1e9:.2f}B params bf16 "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    total = {name: 0 for name in KERNELS}

    def engine(**kw):
        return Engine(model, max_slots=8, num_pages=1024, page_size=16,
                      chunk_size=16, **kw)

    def run_pass(tag, run, needs):
        """``run()`` serves one pass on an engine of its own; the launch
        counters are zeroed just before and read just after."""
        t_pass = time.perf_counter()
        got = _counted(run, needs, tc=tag)[1]  # its engine is gone here
        log(f"{tag}: launches {got}; "
            f"{time.perf_counter() - t_pass:.1f} s")
        if got.pop("flash_attention_bwd"):
            raise AssertionError(f"{tag}: serving launched the backward")
        for name, n in got.items():
            total[name] += n
        gc.collect()  # an engine and its runner hold each other
        torch.cuda.empty_cache()

    seen, streams, notes, reqs_of = {}, {}, {}, {}

    def serve(tag, eng, items, pin=False):
        """Serve ``items`` on ``eng``. ``pin`` fixes the chain-boundary
        cost at the prior (``Engine._cost_pin``, no probes): the measured
        cost follows the host's clock, so a graph run and its eager twin
        would choose other depths and co-batch other rows."""
        if pin:
            _pin(eng)
        note = notes[tag] = _sched_probe(eng)
        reqs, wall = _serve_items(eng, items, tag)
        seen[tag] = _report(tag, reqs, wall, ident)
        streams[tag] = [list(r.tokens) for r in reqs]
        reqs_of[tag] = reqs
        log(f"{tag}: {_graph_note(eng)}")
        log(f"{tag}: scheduler: {_sched_line(eng, note)} [{ident}]")
        return eng

    def eager_twin(tag, eng, items):
        """The items of pass ``tag`` again on ``eng``, a fresh engine with
        its graphs off (the same bodies run eagerly), both pinned to the
        prior boundary cost: the streams must equal the graph pass's."""
        eng.runner._graphs.enabled = False
        serve(f"{tag} eager", eng, items, pin=True)
        if streams[f"{tag} eager"] != streams[tag]:
            raise AssertionError(f"{tag}: the graph and eager streams "
                                 "differ")
        log(f"{tag}: graph and eager streams equal; graphs "
            f"{seen[tag][0]:.1f} tok/s, TTFT median {seen[tag][1]:.1f} ms; "
            f"eager {seen[tag + ' eager'][0]:.1f} tok/s, "
            f"{seen[tag + ' eager'][1]:.1f} ms [{ident}]")
        return eng

    def rand(n):
        return rng.integers(0, cfg.vocab_size, (n,))

    def plain(specs):
        return [(rand(n), m, t, s) for n, m, t, s in specs]

    vanilla = ("paged_decode_attention", "flash_attention_fwd")
    verify = ("paged_verify_attention",)
    # pass 1: 10 mixed requests, two of them sampled, on 8 slots, no eos:
    # the two queued requests are pre-admitted in a chain's shadow. The
    # boundary cost is measured (not pinned), graphs and eager
    items1 = plain([(16, 64, 0.0, None), (1024, 32, 0.0, None),
                    (300, 128, 0.8, 11), (64, 96, 0.0, None),
                    (700, 48, 0.8, 12), (128, 128, 0.0, None),
                    (33, 40, 0.0, None), (512, 64, 0.0, None),
                    (900, 32, 0.0, None), (200, 80, 0.0, None)])
    at_prior = {}

    def main1(tag, graphs):
        eng = engine()
        eng.runner._graphs.enabled = graphs
        serve(tag, eng, items1, pin=False)
        if not notes[tag]["preadmitted"]:
            raise AssertionError(f"{tag}: no request was pre-admitted")
        queued = [round((r._t_first - r._t_arrival) * 1e3, 1)
                  for r in reqs_of[tag][8:]]
        log(f"{tag}: TTFT of the 2 queued requests {queued} ms; "
            f"{notes[tag]['step_s'] * 1e3 / notes[tag]['steps']:.1f} ms a "
            f"step [{ident}]")
        at_prior[tag] = _at_prior(eng)

    peak_bf16 = _peak_pass(torch, lambda: run_pass(
        "main bf16 pages", lambda: main1("main bf16 pages", True), vanilla))
    run_pass("main bf16 pages eager",
             lambda: main1("main bf16 pages eager", False), vanilla)
    # the twins, both pinned to the prior: a run that never left the
    # prior (no probe, no measured ratio) made a pinned run's choices
    for tag, graphs in (("main bf16 pages", True),
                        ("main bf16 pages eager", False)):
        if at_prior[tag]:
            streams[f"{tag} pinned"] = streams[tag]
            log(f"{tag}: every depth used the prior: it is the pinned run")
            continue
        def pinned(tag=tag, graphs=graphs):
            eng = engine()
            eng.runner._graphs.enabled = graphs
            serve(f"{tag} pinned", eng, items1, pin=True)

        run_pass(f"{tag} pinned", pinned, vanilla)
    if streams["main bf16 pages eager pinned"] != \
            streams["main bf16 pages pinned"]:
        raise AssertionError("main bf16 pages: the graph and eager streams "
                             "differ")
    log("main bf16 pages: graph and eager streams equal at the pinned "
        "boundary cost")

    # the boundary cost measured: pass 1 ends in three steps, too few for
    # a sample; 8 requests of 192 tokens at depths 1 and 2 give the fit
    # its samples (three at one depth, then the probes), graphs and eager
    r_cal = np.random.default_rng(40)  # leaves the passes' prompts be
    calib = [(r_cal.integers(0, cfg.vocab_size, (128,)), 192, 0.0, None)
             for _ in range(8)]

    def calibrate(graphs):
        tag = "main calibration" + ("" if graphs else " eager")
        eng = engine(max_chain=2)
        eng.runner._graphs.enabled = graphs
        serve(tag, eng, calib)
        if eng._dispatch_ratio is None:
            raise AssertionError(f"{tag}: the boundary cost was not "
                                 "measured")
        ema = {nb: {k: round(t * 1e3, 3) for k, t in sorted(b.items())}
               for nb, b in eng._chain_time_ema.items()}
        log(f"{tag}: measured boundary cost {eng._dispatch_ratio!r} "
            f"chunks; step wall EMA ms by bucket and depth {ema} [{ident}]")

    run_pass("main calibration", lambda: calibrate(True), vanilla)
    run_pass("main calibration eager", lambda: calibrate(False), vanilla)

    # the chaos pass: the main items, pinned, with two injected faults
    # that fail requests 1 and 3 at their admission's harvest; the rest
    # must stream as the clean pinned run does
    def chaos():
        plan = "nan-logits:rid=1,times=1;step-exception:rid=3,times=1"
        eng = _pin(engine(fault_plan=plan))
        reqs = [eng.add_request(p, m, temperature=t, seed=q)
                for p, m, t, q in items1]
        eng.run()
        torch.cuda.synchronize()
        _no_caught_fault(eng, "main chaos")
        failed = {r.rid: r.failure_reason for r in reqs if r.failed}
        if failed != {1: "nan_logits", 3: "step_fault"}:
            raise AssertionError(f"main chaos: failed {failed}")
        if type(reqs[3].failure.__cause__).__name__ != "InjectedFault":
            raise AssertionError("main chaos: request 3 failed with "
                                 f"{reqs[3].failure!r}")
        for r, want in zip(reqs, streams["main bf16 pages pinned"]):
            if r.rid not in failed and (not r.done or r.tokens != want):
                raise AssertionError(f"main chaos: request {r.rid} differs "
                                     "from the clean pinned run")
        log(f"main chaos: plan {plan!r}: requests 1 (nan_logits) and 3 "
            f"(step_fault, InjectedFault) failed; the other 8 streams equal "
            f"the clean pinned run; no engine-scoped fault [{ident}]")

    run_pass("main chaos", chaos, vanilla)
    # pass 2: int8 KV pages
    items = plain([(100, 48, 0.0, None), (600, 32, 0.8, 21),
                   (250, 64, 0.0, None), (40, 64, 0.0, None)])
    run_pass("main int8 pages",
             lambda: serve("main int8 pages",
                           engine(quantized_cache=True), items), vanilla)

    # pass 3: a pool too small for the run, forcing recompute preemption
    # (each request needs up to 25 pages; 39 usable pages hold one and a
    # half of them)
    def small_pool():
        eng = Engine(model, max_slots=4, num_pages=40, page_size=16,
                     chunk_size=16)
        serve("main small pool", eng,
              plain([(256, 128, 0.0, None), (256, 128, 0.8, 31),
                     (200, 96, 0.0, None)]))
        if eng.preemptions < 1:
            raise AssertionError("the small pool forced no preemption")
        log(f"main small pool: {eng.preemptions} preemptions")

    run_pass("main small pool", small_pool, vanilla)

    # pass 4: prefix cache. A first wave publishes a shared 512-token
    # preamble; the second wave splices it (the suffix program, through
    # the verify kernel), and one request repeats a first-wave prompt of
    # whole pages exactly (a full match: the copy-on-write path)
    def prefix_cache():
        pre = rand(512)
        first = [(np.concatenate([pre, rand(48)]), 64, 0.0, None),
                 (np.concatenate([pre, rand(77)]), 64, 0.0, None)]
        second = [(np.concatenate([pre, rand(n)]), 64, t, s)
                  for n, t, s in ((16, 0.0, None), (50, 0.8, 41),
                                  (90, 0.0, None), (140, 0.0, None),
                                  (200, 0.0, None))]
        second.append((first[0][0], 64, 0.0, None))
        eng = serve("main prefix cache, wave 1", engine(prefix_cache=True),
                    first)
        serve("main prefix cache, wave 2", eng, second)
        hits, cached = eng._pcache.hits, eng._cache.cached_tokens
        log(f"main prefix cache: {hits} hits, {eng._pcache.misses} misses, "
            f"{cached} prefill tokens served from the cache")
        if hits < len(second) or cached < len(second) * 512:
            raise AssertionError(f"the second wave hit {hits} times and "
                                 f"reused {cached} tokens")

    run_pass("main prefix cache", prefix_cache, verify)

    # pass 5: chunked prefill. Two short prompts are decoding when six
    # long ones arrive and stream in 256 tokens a step; then the same items
    # with the roles split (disaggregate=True): the long prompts' chunks
    # through the mixed step (#3) beside the decoding slots' graph-replayed
    # chains (#1), in one step. Both under the profiler (the device's busy
    # time of the same steps)
    short = plain([(20, 64, 0.0, None), (40, 64, 0.8, 51)])
    long_ = plain([(300, 64, 0.0, None), (600, 64, 0.0, None),
                   (900, 64, 0.8, 52), (1200, 64, 0.0, None),
                   (1600, 64, 0.0, None), (2000, 64, 0.0, None)])

    def chunked(tag, make, profiled=True):
        """Pass 5's items on ``make()``: the two short prompts a step
        ahead of the six long ones. ``profiled``: the fifth step of the
        same items on a second engine under the profiler (wall and device
        busy ms of one step; a whole pass replays ~10^6 kernels). Its
        chain replays a graph captured a step before: in a disaggregated
        run the fifth is the first step that runs both roles and
        captures nothing."""
        from torch.profiler import ProfilerActivity, profile

        def start(eng):
            reqs = [eng.add_request(p, m, temperature=t, seed=s)
                    for p, m, t, s in short]
            eng.step()  # binds both and runs their single chunk
            if not all(len(r.tokens) == 1 for r in reqs):
                raise AssertionError("the short prompts are not decoding")
            return reqs + [eng.add_request(p, m, temperature=t, seed=s)
                           for p, m, t, s in long_]

        eng = make()
        note = notes[tag] = _sched_probe(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = start(eng)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_done(reqs, short + long_)
        _no_caught_fault(eng, tag)
        seen[tag] = _report(tag, reqs, wall, ident)
        streams[tag] = [list(r.tokens) for r in reqs]
        line = (f"{tag}: scheduler: {_sched_line(eng, note)}; wall "
                f"{note['step_s'] * 1e3 / note['steps']:.1f} ms a step")
        if eng.disaggregate:
            line += (f"; {note['both_roles']} of {note['disagg_steps']} "
                     "disaggregated steps ran the mixed step and a chain")
            if not note["both_roles"]:
                raise AssertionError(f"{tag}: no step ran both roles")
        if profiled:
            eng = make()
            start(eng)
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
            busy_ms = _device_busy_ms(prof)
            _no_caught_fault(eng, tag)
            line += (f"; its fifth step under the profiler: wall "
                     f"{step_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle "
                     f"{max(0.0, 1 - busy_ms / step_ms):.0%})")
        log(line + f" [{ident}]")

    run_pass("main chunked prefill", lambda: chunked(
        "main chunked prefill", lambda: _pin(engine(prefill_chunk=256))),
        verify)
    disagg = ("paged_decode_attention", "paged_verify_attention")

    # the disaggregated pair at a quarter depth (8 of 32 layers, the same
    # seed): its graph and eager runs are held only to each other, and the
    # eager one, host-bound, was the phase's longest pass
    half = init_llama(dataclasses.replace(cfg, num_layers=8), seed=0,
                      device="cuda", dtype=torch.bfloat16)

    def disagg_engine(graphs=True):
        eng = _pin(Engine(half, max_slots=8, num_pages=1024, page_size=16,
                          chunk_size=16, prefill_chunk=256,
                          disaggregate=True))
        eng.runner._graphs.enabled = graphs
        return eng

    run_pass("main disaggregated", lambda: chunked(
        "main disaggregated", disagg_engine), disagg)

    def disagg_eager():
        chunked("main disaggregated eager", lambda: disagg_engine(False),
                profiled=False)
        if streams["main disaggregated eager"] != \
                streams["main disaggregated"]:
            raise AssertionError("main disaggregated: the graph and eager "
                                 "streams differ")
        log("main disaggregated: graph and eager streams equal at the "
            "pinned boundary cost")

    run_pass("main disaggregated eager", disagg_eager, disagg)
    del half
    gc.collect()
    torch.cuda.empty_cache()

    # pass 6: n-gram speculative decoding over prompts that repeat a
    # 64-token span, so the drafter finds matches
    spec_items = [(np.tile(rand(64), -(-n // 64))[:n], 96, 0.0, None)
                  for n in (200, 280, 360, 440, 520, 600)]

    def spec():
        eng = serve("main spec ngram", engine(spec="ngram", spec_k=4),
                    spec_items, pin=True)
        st = eng._spec.stats()
        steps = max(1, st["verify_steps"])
        log(f"main spec ngram: {st['verify_steps']} verify steps, "
            f"{eng._spec.drafts_accepted} of {eng._spec.drafts_proposed} "
            f"drafts accepted ({eng._spec.drafts_accepted / steps:.2f} per "
            f"verify step), {st['accept_per_step']:.2f} tokens per "
            f"request-row per step")

    run_pass("main spec ngram", spec, verify)
    run_pass("main spec ngram eager", lambda: eager_twin(
        "main spec ngram", engine(spec="ngram", spec_k=4), spec_items),
        verify)
    peak_dense = torch.cuda.max_memory_allocated()

    # ---- pass A: weight-only int8 and int4 weights (kernel #12) --------
    quant = ("quant_matmul",)
    t0 = time.perf_counter()
    _, swapped = quantize_for_decode(model, algo="weight_only_int8")
    torch.cuda.synchronize()
    log(f"main pass A: {swapped} Linears quantized to int8 in "
        f"{time.perf_counter() - t0:.1f} s; weights now "
        f"{_model_gib(model):.2f} GiB")
    peaks = {"bf16": peak_bf16}
    peaks["int8"] = _peak_pass(torch, lambda: run_pass(
        "main int8 weights", lambda: serve("main int8 weights", engine(),
                                           items1, pin=True),
        quant + vanilla))
    run_pass("main int8 weights eager", lambda: eager_twin(
        "main int8 weights", engine(), items1), quant + vanilla)

    def spec_int8():
        items = [(np.tile(rand(64), -(-n // 64))[:n], 96, 0.0, None)
                 for n in (200, 280, 360, 440, 520, 600)]
        serve("main int8 weights spec ngram", engine(spec="ngram",
                                                     spec_k=4), items)

    run_pass("main int8 weights spec ngram", spec_int8, quant + verify)
    del model
    torch.cuda.empty_cache()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    _, swapped = quantize_for_decode(model, algo="weight_only_int4")
    torch.cuda.synchronize()
    log(f"main pass A: {swapped} Linears quantized to int4; weights now "
        f"{_model_gib(model):.2f} GiB")
    items_int4 = plain([(100, 48, 0.0, None), (600, 32, 0.8, 21),
                        (250, 64, 0.0, None), (40, 64, 0.0, None)])
    peaks["int4+int8 pages"] = _peak_pass(torch, lambda: run_pass(
        "main int4 weights int8 pages", lambda: serve(
            "main int4 weights int8 pages", engine(quantized_cache=True),
            items_int4), quant + vanilla))
    for tag, bf in (("main int8 weights", "main bf16 pages"),
                    ("main int4 weights int8 pages", "main int8 pages")):
        log(f"main pass A: {tag} {seen[tag][0]:.1f} tok/s, TTFT median "
            f"{seen[tag][1]:.1f} ms against {bf} {seen[bf][0]:.1f} tok/s, "
            f"{seen[bf][1]:.1f} ms (same requests) [{ident}]")
    log("main pass A: peak memory GiB " + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in peaks.items()) + f" [{ident}]")
    del model
    torch.cuda.empty_cache()

    # ---- pass B: LLaMA-MoE at Mixtral-8x7B widths (kernel #13) ---------
    mcfg = mixtral_8x7b(num_layers=16)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    moe = init_llama(mcfg, seed=2, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main pass B: Mixtral-8x7B widths, {mcfg.num_layers} of 32 layers, "
        f"{mcfg.num_params() / 1e9:.2f}B params bf16 "
        f"({_model_gib(moe):.2f} GiB) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    grouped = ("grouped_matmul",)

    def moe_engine(**kw):
        return Engine(moe, max_slots=8, num_pages=512, page_size=16,
                      chunk_size=16, **kw)

    moe_seen = {}

    def moe_run(tag, eng, items, twin_of=None):
        if twin_of is None:
            serve(tag, eng, items, pin=True)
        else:
            eager_twin(twin_of, eng, items)
            if eng.moe_stats() != moe_seen[twin_of]:
                raise AssertionError(f"{tag}: the graph and eager router "
                                     "stats differ")
        st = moe_seen[tag] = eng.moe_stats()
        log(f"{tag}: moe_stats tokens_routed={st['tokens_routed']:.0f} "
            f"pairs_kept={st['pairs_kept']:.0f} "
            f"pairs_dropped={st['pairs_dropped']:.0f} "
            f"drop_frac={st['drop_frac']:.4f} "
            f"load_imbalance={st['load_imbalance']:.3f} "
            f"router_entropy={st['router_entropy']:.4f} expert_load="
            f"{[int(x) for x in st['expert_load']]}")
        if not st["tokens_routed"] > 0:
            raise AssertionError(f"{tag}: the router saw no token")

    moe_items = [(rand(n), m, t, s) for n, m, t, s in (
        (32, 64, 0.0, None), (512, 32, 0.0, None), (200, 48, 0.8, 61),
        (77, 64, 0.0, None), (384, 40, 0.0, None), (128, 64, 0.8, 62),
        (450, 32, 0.0, None), (260, 56, 0.0, None))]
    run_pass("main moe", lambda: moe_run("main moe", moe_engine(),
                                         moe_items), grouped + vanilla)
    run_pass("main moe eager", lambda: moe_run(
        "main moe eager", moe_engine(), moe_items, twin_of="main moe"),
        grouped + vanilla)
    moe_long = plain([(300, 48, 0.0, None), (560, 48, 0.0, None),
                      (777, 48, 0.8, 63), (1000, 48, 0.0, None)])
    # its 256-token chunks give C >= 64 capacity rows an expert: the
    # prefill chunks' expert GEMMs run on the wgmma body
    run_pass("main moe chunked prefill", lambda: moe_run(
        "main moe chunked prefill", moe_engine(prefill_chunk=256),
        moe_long), grouped + verify + ("grouped_matmul_wgmma",))
    log(f"main pass B: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{ident}]")
    del moe
    torch.cuda.empty_cache()

    log(f"main: peak memory of the dense bf16 serving passes "
        f"{peak_dense / 2**30:.2f} GiB [{ident}]")
    train_passes(ident, total)
    log(f"main: launches {total}")
    for name, n in total.items():
        if n <= 0 and name not in GENERATE_ROWS + CONTEXT_ROWS:
            raise AssertionError(f"the main path never launched {name}")
    return total


# ------------------------------------------------------------ serve
class _Api:
    """The port's ``ApiServer`` over a ``ServingFrontend`` on ``engine``,
    on 127.0.0.1 at an ephemeral port, its event loop on a thread of its
    own; blocking HTTP helpers for the clients."""

    def __init__(self, engine, grace_s=120.0, **frontend_kw):
        import asyncio
        import threading

        from paddle_tpu_torch.serving import ServingFrontend
        from paddle_tpu_torch.serving.server import ApiServer

        self.engine = engine
        self.frontend = ServingFrontend(engine, **frontend_kw)
        self.srv = ApiServer(self.frontend, host="127.0.0.1", port=0,
                             model_name="llama2-7b", grace_s=grace_s)
        self.loop = asyncio.new_event_loop()
        self._bound = threading.Event()
        self._thread = threading.Thread(target=self._run, name="api-loop",
                                        daemon=True)
        self._thread.start()
        if not self._bound.wait(60):
            raise AssertionError("the API server never bound its port")
        self.base = f"http://127.0.0.1:{self.srv.port}"

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.srv.start())
        self._bound.set()
        self.loop.run_forever()

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.status, json.loads(r.read())

    def complete(self, payload, tenant=None, chat=False, timeout=900):
        """One completion: (token ids, finish_reason); SSE when the payload
        says ``stream``."""
        import urllib.request

        path = "/v1/chat/completions" if chat else "/v1/completions"
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Tenant"] = tenant
        req = urllib.request.Request(self.base + path,
                                     data=json.dumps(payload).encode(),
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not payload.get("stream"):
                choice = json.loads(r.read())["choices"][0]
                return choice["token_ids"], choice["finish_reason"]
            toks, finish = [], None
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                toks.extend(choice["token_ids"])
                finish = choice["finish_reason"] or finish
            return toks, finish

    def disconnect_mid_stream(self, prompt, max_tokens):
        """Open an SSE completion, read its first chunk, hang up."""
        import socket

        body = json.dumps({"prompt": [int(t) for t in prompt],
                           "max_tokens": max_tokens,
                           "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", self.srv.port),
                                      timeout=600) as raw:
            raw.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                        b"Content-Type: application/json\r\n"
                        + f"Content-Length: {len(body)}\r\n\r\n".encode()
                        + body)
            got = b""
            while b'"token_ids": [' not in got:
                chunk = raw.recv(65536)
                if not chunk:
                    raise AssertionError("the stream ended before a chunk")
                got += chunk

    def post_raw(self, path, body: bytes, timeout=900):
        """(status, JSON reply, reply bytes) of one POST of ``body``."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base + path, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                raw = r.read()
                return r.status, json.loads(raw), len(raw)
        except urllib.error.HTTPError as e:
            raw = e.read()
            return e.code, json.loads(raw), len(raw)

    def first_token_s(self, prompt, max_tokens):
        """Seconds from sending an SSE completion to its first token chunk
        (the client's TTFT), and the stream's tokens."""
        import urllib.request

        body = json.dumps({"prompt": [int(t) for t in prompt],
                           "max_tokens": max_tokens,
                           "stream": True}).encode()
        req = urllib.request.Request(
            self.base + "/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        first, toks = None, []
        with urllib.request.urlopen(req, timeout=900) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                got = json.loads(line[6:])["choices"][0]["token_ids"]
                if got and first is None:
                    first = time.perf_counter() - t0
                toks.extend(got)
        return first, toks

    def close(self, check=True):
        """Drain and stop; fails if the engine thread died of a fault (and,
        with ``check``, if the engine caught one or was quarantined)."""
        import asyncio

        fut = asyncio.run_coroutine_threadsafe(self.srv.shutdown(),
                                               self.loop)
        fut.result(timeout=300)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise AssertionError("the API server's loop did not stop")
        self.loop.close()
        if self.frontend.fault is not None:
            raise AssertionError(
                f"the engine thread died: {self.frontend.fault!r}")
        if check:
            _no_caught_fault(self.engine, "the API server's engine")


def _run_clients(jobs, threads):
    """Run the callables ``jobs`` on ``threads`` client threads; returns
    their results in order and re-raises the first failure."""
    import threading

    results = [None] * len(jobs)
    errors = []
    nxt = iter(range(len(jobs)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            try:
                results[i] = jobs[i]()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append((i, e))

    ts = [threading.Thread(target=worker, name=f"client-{k}")
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=1800)
    if any(t.is_alive() for t in ts):
        raise AssertionError("a client thread hung")
    if errors:
        i, e = errors[0]
        raise AssertionError(f"client job {i} failed: {e!r}") from e
    return results


def _metric(name, labels=None):
    """A counter's total (or one label series) in the port's registry."""
    from paddle_tpu_torch.observability import REGISTRY

    m = REGISTRY.get(name)
    if m is None:
        return 0.0
    return float(sum(leaf.value for key, leaf in m.series()
                     if labels is None
                     or dict(m.label_pairs(key)) == labels))


def _hist(name):
    """(count, sum) of a histogram over its label series."""
    from paddle_tpu_torch.observability import REGISTRY

    m = REGISTRY.get(name)
    if m is None:
        return 0, 0.0
    leaves = [leaf for _, leaf in m.series()]
    return sum(l.count for l in leaves), sum(l.sum for l in leaves)


def _scrape_ttft_count():
    """The TTFT histogram's count summed over tenants, parsed from a
    ``render_prometheus`` scrape."""
    from paddle_tpu_torch.observability import render_prometheus

    text = render_prometheus()
    total = 0
    for line in text.splitlines():
        if line.startswith("paddle_serving_ttft_seconds_count"):
            total += int(float(line.rsplit(" ", 1)[1]))
    if "# TYPE paddle_serving_ttft_seconds histogram" not in text:
        raise AssertionError("the scrape has no TTFT histogram")
    return total


def _drained(eng):
    """Nothing active or queued, and every page free or cached idle."""
    return (not eng._active and not eng._queue
            and int(eng._page_ref.sum()) == 0
            and len(eng._free_slots) == eng.max_slots)


def _wait_for(cond, timeout, what):
    t_end = time.perf_counter() + timeout
    while time.perf_counter() < t_end:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _serve_items_direct(make_engine, items):
    """A direct ``Engine.run`` of ``items`` [(prompt, budget, temperature,
    seed)] on a fresh engine, freed after: (streams, wall seconds)."""
    import torch

    eng = make_engine()
    reqs, wall = _serve_items(eng, items)
    del eng
    gc.collect()  # an engine and its runner hold each other
    torch.cuda.empty_cache()
    return [list(r.tokens) for r in reqs], wall


def phase_serve(ident):
    """``llama2_7b``, bf16, full width and depth, random weights from a
    seed, prefix cache on, served through the port's ``ApiServer`` over
    sockets (see the module docstring); then the multi-step round and the
    f32 identity. Launches of the HTTP pass are counted and returned."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.llama import LlamaConfig, llama2_7b
    from paddle_tpu_torch.serving import ServingFrontend
    from paddle_tpu_torch.serving.loadgen import _mk_prompt, run_closed_loop
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    # every kernel is built before any front-end thread starts
    build.build_all()
    cfg = llama2_7b()
    model = init_llama(cfg, seed=4, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rng = np.random.default_rng(4)
    vocab = cfg.vocab_size
    geo = dict(max_slots=8, num_pages=1024, page_size=16, chunk_size=16,
               max_chain=4, prefix_cache=True)

    def rand(n):
        return rng.integers(0, vocab, (n,))

    def engine(**kw):
        return Engine(model, **dict(geo, **kw))

    weights = {"interactive": 4.0, "batch": 1.0}
    api = _Api(engine(multi_step=4), tenant_weights=weights)
    eng = api.engine
    log(f"serve: llama2_7b bf16 behind the API server at {api.base} "
        f"(8 slots, prefix cache, multi_step 4, tenants {weights})")
    # ---- the HTTP pass, counted ----------------------------------------
    ident_items = [(rand(n), m, t, s) for n, m, t, s in (
        (200, 32, 0.0, None), (600, 24, 0.0, None), (90, 40, 0.8, 77))]
    shared = rand(256)
    load = []
    for i in range(24):
        if i % 2 == 0:
            prompt = np.concatenate([shared, rand(int(rng.integers(16, 769)))])
        else:
            prompt = rand(int(rng.integers(16, 1025)))
        sampled = i in (3, 8, 15, 20)
        load.append(dict(prompt=prompt, max_tokens=int(rng.integers(24, 49)),
                         temperature=0.8 if sampled else 0.0,
                         seed=500 + i if sampled else None,
                         stream=i % 4 in (1, 2),
                         tenant="interactive" if i % 3 == 0 else "batch"))
    hang_up, late = rand(64), rand(40)
    c0 = {k: _metric(k) for k in (
        "paddle_serving_requests_completed_total",
        "paddle_tpu_engine_recoveries_total")}
    cancelled0 = _metric("paddle_tpu_request_failures_total",
                         {"reason": "cancelled", "tenant": "default"})
    ttft0 = _scrape_ttft_count()
    box = {}

    def http_pass():
        # identity at bf16: three requests one at a time
        outs = []
        for i, (p, m, t, s) in enumerate(ident_items):
            payload = {"prompt": [int(x) for x in p], "max_tokens": m,
                       "temperature": t, "stream": i > 0}
            if s is not None:
                payload["seed"] = s
            outs.append(api.complete(payload))
        box["ident"] = outs
        # the load: 24 requests from 8 clients, a client that hangs up
        # mid-stream and a request whose deadline (0 ms) cannot be met
        jobs = [lambda: api.disconnect_mid_stream(hang_up, 400),
                lambda: api.complete({"prompt": [int(x) for x in late],
                                      "max_tokens": 16, "deadline_ms": 0})]
        for it in load:
            payload = {"prompt": [int(x) for x in it["prompt"]],
                       "max_tokens": it["max_tokens"],
                       "temperature": it["temperature"],
                       "stream": it["stream"]}
            if it["seed"] is not None:
                payload["seed"] = it["seed"]
            jobs.append(lambda payload=payload, it=it: api.complete(
                payload, tenant=it["tenant"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["load"] = _run_clients(jobs, 8)[1:]
        box["load_wall"] = time.perf_counter() - t0
        _wait_for(lambda: _drained(eng), 600, "the engine to drain")

    _, launches = _counted(http_pass, needs=(
        "paged_decode_attention", "flash_attention_fwd",
        "paged_verify_attention"), tc="serve")
    log(f"serve: launches {launches}")
    if launches.pop("flash_attention_bwd"):
        raise AssertionError("serving launched the backward")
    deadline_out, *load_out = box["load"]
    if deadline_out != ([], "deadline"):
        raise AssertionError(f"the short-deadline request ended "
                             f"{deadline_out}")
    for it, (toks, finish) in zip(load, load_out):
        if finish != "stop" or len(toks) != it["max_tokens"]:
            raise AssertionError(f"a load request ended {finish} with "
                                 f"{len(toks)}/{it['max_tokens']} tokens")
    cancelled = _metric("paddle_tpu_request_failures_total",
                        {"reason": "cancelled", "tenant": "default"}) \
        - cancelled0
    if cancelled != 1:
        raise AssertionError(f"{cancelled} requests ended cancelled, not 1 "
                             "(the client that hung up)")
    completed = _metric("paddle_serving_requests_completed_total") \
        - c0["paddle_serving_requests_completed_total"]
    ttft_n = _scrape_ttft_count() - ttft0
    # every request that delivered a first token: the 27 that finished and
    # the one cancelled mid-stream (the deadline one delivered none)
    if completed != 27 or ttft_n != completed + 1:
        raise AssertionError(f"{completed} finished, TTFT count {ttft_n}")
    if _metric("paddle_tpu_engine_recoveries_total") \
            != c0["paddle_tpu_engine_recoveries_total"]:
        raise AssertionError("a step fault was recovered in the serve pass")
    _no_caught_fault(eng, "serve HTTP pass")
    for name in ("/healthz", "/readyz"):
        status, body = api.get(name)
        if status != 200 or body.get("status") not in ("ok", "ready"):
            raise AssertionError(f"{name}: {status} {body}")
    pages = eng._cache.k_pages + eng._cache.v_pages
    if any(p.grad_fn is not None or p.requires_grad for p in pages):
        raise AssertionError("the engine thread recorded autograd history")
    toks = sum(len(t) for t, _ in load_out)
    log(f"serve: 24 requests over HTTP from 8 clients ({sum(it['stream'] for it in load)} "
        f"SSE, 4 sampled, 12 on a shared 256-token prefix), a client that "
        f"hung up mid-stream (cancelled, its pages back in the pool) and a "
        f"0 ms deadline (failed 'deadline'): {toks} tokens in "
        f"{box['load_wall']:.3f} s = {toks / box['load_wall']:.1f} tok/s; "
        f"{eng._pcache.hits} prefix hits; /healthz, /readyz 200; the "
        f"scrape's TTFT count {ttft_n} = 27 finished + 1 cancelled; the "
        f"pass took {time.perf_counter() - t_phase:.1f} s [{ident}]")
    # identity at bf16: each request alone on a fresh engine
    for (p, m, t, s), (got, finish) in zip(ident_items, box["ident"]):
        want, _ = _serve_items_direct(engine, [(p, m, t, s)])
        if finish != "stop" or got != want[0]:
            raise AssertionError(
                f"serve bf16 identity: HTTP {got[:8]}... ({finish}) != "
                f"direct {want[0][:8]}...")
    log("serve: bf16 identity: 3 requests one at a time over HTTP (1 unary, "
        "2 SSE, 1 sampled) equal a direct Engine.run of each alone")
    api.close()
    del api, eng
    gc.collect()
    torch.cuda.empty_cache()
    # ---- closed loop through a front end with no tenant weights --------
    # (the API server's weights make every share hard: its default tenant
    # would hold one slot)
    t0 = time.perf_counter()
    n_cl, budget, prange, seed = 16, 32, (16, 1024), 9
    loops = []
    # the same items three times, each on a fresh engine (the prefix cache
    # starts empty): the host is shared, so the repeats give the spread;
    # the third runs under the profiler, and its engine steps give both
    # the wall (the step_seconds histogram) and the device busy time
    for rep in range(3):
        fe = ServingFrontend(engine(multi_step=4)).start()
        s0 = _hist("paddle_tpu_engine_steps_per_roundtrip")
        h0 = _hist("paddle_serving_step_seconds")
        with (profile(activities=[ProfilerActivity.CUDA]) if rep == 2
              else contextlib.nullcontext()) as prof:
            stats = run_closed_loop(
                fe, concurrency=8, n_requests=n_cl, vocab=vocab,
                prompt_range=prange, budget=budget, seed=seed,
                timeout_s=900)
            torch.cuda.synchronize()
        s1 = _hist("paddle_tpu_engine_steps_per_roundtrip")
        h1 = _hist("paddle_serving_step_seconds")
        fe.drain(grace_s=60.0)
        if fe.fault is not None:
            raise AssertionError(f"the engine thread died: {fe.fault!r}")
        _no_caught_fault(fe.engine, "serve closed loop")
        if stats["completed"] != n_cl:
            raise AssertionError(f"closed loop: {stats}")
        steps = s1[0] - s0[0]
        tag = (f"closed loop {rep + 1} of 3"
               + (" (under the profiler)" if prof is not None else ""))
        log(f"serve: {tag} through the front end, concurrency 8, {n_cl} "
            f"requests of {budget} tokens, prompts {prange[0]}-{prange[1]}: "
            f"{stats['tokens_per_sec']:.1f} tok/s, TTFT ms median "
            f"{stats['ttft_p50_ms']:.1f} p99 {stats['ttft_p99_ms']:.1f} (the "
            f"tickets); {steps} engine steps, steps_per_roundtrip mean "
            f"{(s1[1] - s0[1]) / max(1, steps):.2f} [{ident}]")
        if prof is not None:
            wall_ms = 1e3 * (h1[1] - h0[1])
            busy_ms = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            log(f"serve: {tag}: the same {steps} engine steps took wall "
                f"{wall_ms / max(1, steps):.1f} ms a step, device busy "
                f"{busy_ms / max(1, steps):.1f} ms a step (idle "
                f"{max(0.0, 1 - busy_ms / max(wall_ms, 1e-9)):.0%} of the "
                f"steps' wall) [{ident}]")
        else:
            loops.append(stats["tokens_per_sec"])
        del fe
        gc.collect()  # an engine and its runner hold each other
        torch.cuda.empty_cache()
    r = np.random.default_rng(seed)
    direct, wall = _serve_items_direct(engine, [
        (_mk_prompt(r, vocab, *prange), budget, 0.0, seed + i)
        for i in range(n_cl)])
    d_toks = sum(len(t) for t in direct)
    log(f"serve: closed loops 1-2 {min(loops):.1f}-{max(loops):.1f} tok/s "
        f"(max/min {max(loops) / min(loops):.2f}); a direct Engine.run of "
        f"the same items queued at once: {d_toks / wall:.1f} tok/s; "
        f"{time.perf_counter() - t0:.1f} s [{ident}]")
    # ---- multi_step 4 against 1 on a pure-decode round -----------------
    t0 = time.perf_counter()
    items = [(rand(128), 96, t, s) for t, s in
             ((0.0, None), (0.0, None), (0.8, 81), (0.0, None))]
    rounds = {}
    for ms in (1, 4):
        c, s = _hist("paddle_tpu_engine_steps_per_roundtrip")
        # one-chunk chains: the rest of the round is several chains, which
        # multi_step=4 launches back to back behind one fetch
        streams, wall = _serve_items_direct(
            lambda: engine(multi_step=ms, max_chain=1), items)
        c1, s1_ = _hist("paddle_tpu_engine_steps_per_roundtrip")
        rounds[ms] = (streams, (s1_ - s) / max(1, c1 - c), c1 - c,
                      384 / wall)
    if rounds[1][0] != rounds[4][0]:
        raise AssertionError("serve: multi_step=4 streams differ from "
                             "multi_step=1")
    if not rounds[4][1] > 1.0:
        raise AssertionError("serve: the multi-step path never engaged")
    log(f"serve: pure-decode round (4 requests, 128 + 96 tokens): "
        f"multi_step=4 streams equal multi_step=1; steps_per_roundtrip mean "
        f"{rounds[1][1]:.2f} over {rounds[1][2]} steps vs "
        f"{rounds[4][1]:.2f} over {rounds[4][2]} steps; "
        f"{rounds[1][3]:.1f} vs {rounds[4][3]:.1f} tok/s; "
        f"{time.perf_counter() - t0:.1f} s [{ident}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # ---- identity at f32: llama2_7b widths, 2 layers -------------------
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    try:
        cfg32 = LlamaConfig(num_layers=2)
        m32 = init_llama(cfg32, seed=5, device="cuda", dtype=torch.float32)

        def engine32(**kw):
            return Engine(m32, max_slots=8, num_pages=256, page_size=16,
                          chunk_size=16, max_chain=4, prefix_cache=True,
                          **kw)

        items32 = [(rand(n), m, 0.0, None) for n, m in (
            (40, 24), (100, 32), (300, 24), (77, 40), (500, 24), (12, 32))]
        api = _Api(engine32(multi_step=4))
        got = _run_clients([
            lambda p=p, m=m, i=i: api.complete(
                {"prompt": [int(x) for x in p], "max_tokens": m,
                 "stream": i % 2 == 0})
            for i, (p, m, _t, _s) in enumerate(items32)], 6)
        api.close()
        want, _ = _serve_items_direct(engine32, items32)
        if [g[0] for g in got] != want or any(g[1] != "stop" for g in got):
            raise AssertionError("serve f32 identity: concurrent HTTP "
                                 "streams differ from Engine.run")
        log("serve: f32 identity (llama2_7b widths, 2 layers): 6 concurrent "
            f"greedy HTTP streams (3 SSE) equal a direct Engine.run; "
            f"{time.perf_counter() - t0:.1f} s")
        del api, m32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ generate
@contextlib.contextmanager
def _plain_decode():
    """The decode wrappers of #4, #14 and #15 replaced by their plain
    versions (the module globals the cache code calls), so a run on the
    card can be held against the same run on the plain versions."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = (da.decode_attention, da.decode_attention_slab,
             pa.paged_decode_attention)
    da.decode_attention = lambda q, k, v, lens, scale=None: \
        da.decode_attention_ref(q, k, v, lens, scale)
    da.decode_attention_slab = lambda q, kv, lens, scale=None: \
        da._slab_ref(q, kv, lens, scale)
    pa.paged_decode_attention = pa.paged_decode_attention_ref
    try:
        yield
    finally:
        (da.decode_attention, da.decode_attention_slab,
         pa.paged_decode_attention) = saved


def _generate_ms(model, ids, new, max_seq, reps=3, **kw):
    """``bench.py``'s differential: the median over ``reps`` of
    generate(new) minus generate(new // 4) with the cache size pinned,
    each run ending in a device sync, over the ``new - new // 4`` decode
    steps it isolates (prefill and set-up cancel), after one untimed short
    run. Returns (ms a step, the last long run's output)."""
    import torch

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=n, max_seq=max_seq, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    short = new // 4
    timed(short)
    diffs, out = [], None
    for _ in range(reps):
        t_long, out = timed(new)
        diffs.append(t_long - timed(short)[0])
    return 1e3 * sorted(diffs)[reps // 2] / (new - short), out


def _two_windows(llama, lids, ident):
    """``generate`` on ``llama2_7b`` with a 1024-token window, then a
    2048-token one: the model keeps one captured step after a call, so the
    second call drops the first's slab caches before it makes its own.
    Logs each window's caches, the bytes held after the call returns and
    the peak during it, both over the weights; fails if the first's
    caches outlive the second call or the two are ever held at once."""
    import torch

    cfg = llama.config
    batch = lids.shape[0]
    llama.__dict__.pop("_decode_graph_set", None)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rows = []
    for window in (1024, 2048):
        torch.cuda.reset_peak_memory_stats()
        llama.generate(lids, max_new_tokens=32, max_seq=window,
                       temperature=0.0)
        torch.cuda.synchronize()
        caches = (cfg.num_layers * 2 * batch * window * cfg.num_kv_heads
                  * cfg.head_dim * 2)
        rows.append((window, caches, torch.cuda.memory_allocated() - base,
                     torch.cuda.max_memory_allocated() - base))
    gib = 2**30
    for window, caches, held, peak in rows:
        log(f"generate G2 two windows: window {window}: slab caches "
            f"{caches / gib:.3f} GiB, held after return {held / gib:.3f} "
            f"GiB, peak during the call {peak / gib:.3f} GiB, both over the "
            f"weights [{ident}]")
    (_, c1, _, _), (_, c2, h2, p2) = rows
    if len(llama._decode_graphs().steps) != 1 or h2 >= c2 + c1 // 2 \
            or p2 >= c2 + c1 // 2:
        raise AssertionError("G2 two windows: the first window's caches "
                             "were held with the second's")


def _report_decode(tag, ms, model, batch, prompt, total, kv_width, layers,
                   peak, ident):
    """Log ms a step, tokens/s and ``bench.py``'s per-step HBM floor:
    every parameter and buffer byte once plus every layer's K and V window
    (averaged over the decode range) once, over 3.35 TB/s."""
    weight_bytes = _model_gib(model) * 2**30
    avg_window = (prompt + total) / 2
    kv_bytes = layers * 2 * batch * avg_window * kv_width * 2
    floor_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"generate {tag}: {ms:.4f} ms a decode step of {batch} tokens, "
        f"{batch / ms * 1e3:.1f} tokens/s; HBM floor {floor_ms:.4f} ms "
        f"(weights {weight_bytes / 1e6:.1f} MB + K/V window "
        f"{kv_bytes / 1e6:.1f} MB), floor/measured {floor_ms / ms:.4f}; "
        f"peak {peak / 2**30:.2f} GiB [{ident}]")
    return {"ms": ms, "tok_s": batch / ms * 1e3, "floor_ms": floor_ms,
            "peak_gib": peak / 2**30}


def _teacher_forced(model, ids, caches, tokens):
    """Per-step last-position logits of a prefill of ``ids`` and one
    decode step per column of ``tokens`` [B, T] at time_step prompt + t,
    f32 [T + 1, B, V]; ends in a device sync."""
    import torch

    prompt = ids.shape[1]
    with torch.no_grad():
        out, caches = model(ids, caches=caches)
        steps = [out[:, -1].float()]
        for t in range(tokens.shape[1]):
            out, caches = model(tokens[:, t:t + 1], caches=caches,
                                time_step=prompt + t)
            steps.append(out[:, -1].float())
    torch.cuda.synchronize()
    return torch.stack(steps)


def _layout_caches(model, kind, batch, max_seq, dtype, quant=False):
    """One cache per layer: ``slab`` (``init_caches``), ``5d`` ([2, B, Hkv,
    S, D], user-allocated) or ``paged`` (``PagedKVCache``, 16-row pages,
    int8 with ``quant``)."""
    import torch

    from paddle_tpu_torch.ops.cuda.paged_attention import PagedKVCache

    cfg = model.config
    kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    hd = cfg.hidden_size // cfg.num_heads
    if kind == "slab":
        return model.init_caches(batch, max_seq, dtype)
    if kind == "5d":
        return [torch.zeros((2, batch, kv, max_seq, hd), dtype=dtype,
                            device=model.device)
                for _ in range(cfg.num_layers)]
    pages = -(-max_seq // 16)
    return [PagedKVCache(batch * pages + 1, 16, batch, kv, hd, pages,
                         dtype=dtype, quantized=quant, device=model.device)
            for _ in range(cfg.num_layers)]


def _close_logits(tag, got, want, rel):
    """Fail unless ``got`` is finite and within ``rel`` of ``want``'s
    largest entry; log and return the error."""
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > rel * top:
        raise AssertionError(f"{tag}: logits off by {err:.3g} (largest "
                             f"{top:.3g}, limit {rel} of it)")
    log(f"{tag}: per-step logits within {err:.3g} (largest entry "
        f"{top:.3g}, limit {rel:g} of it)")
    return err


def _layout_pass(tag, model, ids, steps, kinds, dtype, rel, ident):
    """``model`` decodes ``steps`` greedy tokens from ``ids`` on slab
    caches; then the same tokens are fed (teacher-forced) through each
    cache kind of ``kinds`` [(kind, quant)], with the kernels and, for
    bf16, again on the plain versions. Each kind's per-step logits are
    held against its plain run (bf16) or the slab run (f32) within
    ``rel`` of the largest logit. Logs host ms a decode step."""
    import torch

    B, prompt = ids.shape
    total = prompt + steps + 1
    out = model.generate(ids, max_new_tokens=steps + 1, temperature=0.0,
                         max_seq=total)
    toks = out[:, prompt:prompt + steps]
    slab = None
    for kind, quant in kinds:
        name = f"{tag} {kind}{' int8' if quant else ''}"
        caches = _layout_caches(model, kind, B, total, dtype, quant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _teacher_forced(model, ids, caches, toks)
        wall = time.perf_counter() - t0
        log(f"generate {name}: prefill {prompt} + {steps} decode steps in "
            f"{wall * 1e3:.1f} ms ({wall * 1e3 / (steps + 1):.2f} ms a "
            f"step) [{ident}]")
        if dtype == torch.float32:
            if kind == "slab":
                slab = got
            else:
                _close_logits(f"check {name} against the slab", got, slab,
                              rel)
            continue
        with _plain_decode():
            want = _teacher_forced(model, ids, _layout_caches(
                model, kind, B, total, dtype, quant), toks)
        _close_logits(f"check {name} against its plain run", got, want, rel)
        del want
    return out


def _mmha_step(torch, B, H, D, S, ident):
    """One ``masked_multihead_attention`` step at GPT-2 small widths,
    bf16, ragged lengths: the cache row written in place and #14's output
    against the plain version over the updated cache."""
    from paddle_tpu_torch.incubate.nn.functional import \
        masked_multihead_attention
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(44)
    cache = torch.randn((2, B, H, S, D), generator=g,
                        device="cuda").to(torch.bfloat16)
    x = torch.randn((B, 3 * H * D), generator=g,
                    device="cuda").to(torch.bfloat16)
    lens = torch.tensor([128 + 61 * i for i in range(B)], dtype=torch.int32,
                        device="cuda")
    out, same = masked_multihead_attention(x, cache_kv=cache,
                                           sequence_lengths=lens)
    torch.cuda.synchronize()
    qkv = x.view(B, 3, H, D)
    rows = torch.arange(B, device="cuda")
    if same is not cache or not torch.equal(
            cache[0][rows, :, lens.long()], qkv[:, 1]):
        raise AssertionError("masked_multihead_attention did not write the "
                             "new row in place")
    want = da.decode_attention_ref(qkv[:, 0], cache[0], cache[1], lens + 1)
    rec = _decode_record(torch, "masked_multihead_attention", out,
                         want.reshape(B, H * D), torch.bfloat16)
    log(f"generate G3 masked_multihead_attention B={B} H={H} D={D} S={S} "
        f"bf16: max_abs_err {rec['max_abs_err']:.3g} (limit "
        f"{rec['tolerance']:.3g}) [{ident}]")


def _match_cacheless_rows(model, out, prompt, tag):
    """Each row of a greedy ``generate`` output against the argmax of the
    cacheless forward, token by token; a row stops at its first near-tie
    (top-2 gap under 1e-4); at least 16 tokens of each row compared."""
    import torch

    for b in range(out.shape[0]):
        seq = out[b:b + 1, :prompt]
        compared = 0
        with torch.no_grad():
            for tok in out[b, prompt:].tolist():
                logits = model(seq)[0, -1]
                top2 = torch.topk(logits, 2).values
                if (top2[0] - top2[1]).item() < 1e-4:
                    break
                want = int(torch.argmax(logits))
                if want != tok:
                    raise AssertionError(f"{tag} row {b}: token {compared} "
                                         f"is {tok}, the cacheless forward "
                                         f"says {want}")
                compared += 1
                seq = torch.cat([seq, seq.new_tensor([[tok]])], dim=1)
        if compared < 16:
            raise AssertionError(f"{tag} row {b}: only {compared} tokens "
                                 "compared before a near-tie")
        log(f"check {tag}: row {b} matches the cacheless forward on "
            f"{compared}/{out.shape[1] - prompt} tokens")


def phase_generate(ident):
    """KV-cache generation (``GenerationMixin.generate``) at the repo's
    decode benchmark shape and ``llama2_7b``, random weights from a seed:

    - G1: GPT-2 small, full depth, bf16, B=8, prompt 128, 512 new tokens,
      greedy, max_seq 640 (``bench.py:143-275``; #2 prefill, #15 decode),
      then with int8 and int4 weights (#12);
    - G2: ``llama2_7b``, full depth, bf16, B=8, prompt 128, 128 new
      tokens, greedy and sampled (temperature 0.8, top-k 40, seed 3);
      then a 1024-token window and a 2048-token one in turn, with the
      memory each leaves held and its peak;
    - G3: GPT-2 small on user-allocated [2, B, H, S, D] caches (#14) and
      one ``masked_multihead_attention`` step;
    - G4: GPT-2 small and ``llama2_7b`` on ``PagedKVCache`` (16-row
      pages, bf16 and int8; #4);
    - checks, 2-layer full-width f32 models (tf32 off): greedy
      ``generate`` against the cacheless argmax, and the 5-D and paged
      per-step logits against the slab's. The bf16 G3/G4 runs are held
      against the same runs on the plain versions.

    Timing as ``bench.py``: generate(new) minus generate(new / 4), median
    of 3 for G1 bf16 (one difference for the quantized G1 passes and G2,
    to keep the phase near two minutes), per decode step of B tokens.
    Launches are counted per pass; returns the summed launches."""
    import torch

    from paddle_tpu_torch.convert import init_gpt, init_llama
    from paddle_tpu_torch.models.gpt import gpt2_small
    from paddle_tpu_torch.models.llama import LlamaConfig, llama2_7b
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    t_phase = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    bf16 = torch.bfloat16

    def run(tag, fn, needs, tc=True):
        res, got = _counted(fn, needs, tc=tag if tc else None)
        if got.pop("flash_attention_bwd"):
            raise AssertionError(f"{tag}: generation launched the backward")
        log(f"{tag}: launches {got}")
        for name, n in got.items():
            total[name] += n
        return res

    g = torch.Generator(device="cuda").manual_seed(5)
    slab = ("decode_attention_slab", "flash_attention_fwd")

    # ---- G1: GPT-2 small, bench_decode's shape --------------------------
    cfg = gpt2_small()
    B, prompt, new, max_seq = 8, 128, 512, 640
    ids = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                        device="cuda")
    figures = {}

    def g1(tag, model, reps, graphs=True):
        gc.collect()
        model._decode_graphs().enabled = graphs
        torch.cuda.reset_peak_memory_stats()
        ms, out = _generate_ms(model, ids, new, max_seq, reps,
                               temperature=0.0)
        model._decode_graphs().enabled = True
        if out.shape != (B, prompt + new) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"G1 {tag}: bad output {tuple(out.shape)}")
        figures[tag] = _report_decode(
            f"G1 GPT-2 small {tag}", ms, model, B, prompt, max_seq,
            cfg.hidden_size, cfg.num_layers,
            torch.cuda.max_memory_allocated(), ident)
        return out

    gpt = init_gpt(cfg, seed=0, device="cuda", dtype=bf16).eval()
    per_pass = _counted(lambda: gpt.generate(
        ids, max_new_tokens=new, temperature=0.0, max_seq=max_seq),
        needs=slab, tc="generate G1 prefill")[1]
    log(f"generate G1: one generate pass (B=8, 128 + 512) launches "
        f"{ {k: v for k, v in per_pass.items() if v} }")
    out_bf16 = run("G1 bf16", lambda: g1("bf16", gpt, 3), slab)
    # the same decode step run eagerly (graphs off): equal ids; one timed
    # repetition (each eager 512-token generate takes seconds)
    out_eager = run("G1 bf16 eager", lambda: g1("bf16 eager", gpt, 1,
                                                graphs=False), slab)
    if not torch.equal(out_eager, out_bf16):
        raise AssertionError("G1: the graph and eager ids differ")
    log(f"generate G1: graph and eager ids equal; "
        f"{figures['bf16']['ms']:.4f} against "
        f"{figures['bf16 eager']['ms']:.4f} ms a decode step [{ident}]")
    # one decode step under the profiler: host wall against device busy
    caches = gpt.init_caches(B, max_seq, bf16)
    with torch.no_grad():
        gpt(ids, caches=caches)
        tok = out_bf16[:, prompt:prompt + 1]
        _profile_call(lambda: gpt(tok, caches=caches, time_step=prompt),
                      "GPT-2 small bf16 decode step (B=8, ~129-token "
                      "window)", 1, ident)
    del caches

    # ---- G3: user-allocated 5-D caches (#14), masked MHA ----------------
    run("G3 5-D caches", lambda: _layout_pass(
        "G3 GPT-2 small bf16", gpt, ids, 64, [("5d", False)], bf16, 0.03,
        ident), ("decode_attention",))
    run("G3 masked_multihead_attention",
        lambda: _mmha_step(torch, B, cfg.num_heads, cfg.head_dim, max_seq,
                           ident), ("decode_attention",))
    # ---- G4 (GPT-2 small): PagedKVCache, bf16 and int8 pages (#4) ------
    run("G4 GPT-2 small paged", lambda: _layout_pass(
        "G4 GPT-2 small bf16", gpt, ids, 32, [("paged", False),
                                             ("paged", True)], bf16, 0.03,
        ident), ("paged_decode_attention_v1",))

    # ---- G1 with int8 and int4 weights (#12) ----------------------------
    quant = slab + ("quant_matmul",)
    quantize_for_decode(gpt, algo="weight_only_int8")
    out8 = run("G1 int8 weights", lambda: g1("int8 weights", gpt, 1),
               quant)
    del gpt
    torch.cuda.empty_cache()
    gpt = init_gpt(cfg, seed=0, device="cuda", dtype=bf16).eval()
    quantize_for_decode(gpt, algo="weight_only_int4")
    out4 = run("G1 int4 weights", lambda: g1("int4 weights", gpt, 1),
               quant)
    for tag, o in (("int8", out8), ("int4", out4)):
        same = float((o[:, prompt:] == out_bf16[:, prompt:]).float().mean())
        log(f"generate G1: {tag} weights' greedy tokens equal bf16's on "
            f"{same:.3f} of positions")
    del gpt, out8, out4
    gc.collect()
    torch.cuda.empty_cache()

    # ---- G2: llama2_7b, full depth -------------------------------------
    lcfg = llama2_7b()
    t0 = time.perf_counter()
    llama = init_llama(lcfg, seed=0, device="cuda", dtype=bf16)
    torch.cuda.synchronize()
    log(f"generate G2: llama2_7b initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    lids = torch.randint(0, lcfg.vocab_size, (B, prompt), generator=g,
                         device="cuda")
    outs = {}
    for tag, kw in (("greedy", dict(temperature=0.0)),
                    ("sampled", dict(temperature=0.8, top_k=40, seed=3))):
        def g2(tag=tag, kw=kw, graphs=True):
            gc.collect()
            llama._decode_graphs().enabled = graphs
            name = tag if graphs else f"{tag} eager"
            torch.cuda.reset_peak_memory_stats()
            ms, outs[name] = _generate_ms(llama, lids, 128, prompt + 128,
                                          1, **kw)
            llama._decode_graphs().enabled = True
            figures[f"llama {name}"] = _report_decode(
                f"G2 llama2_7b bf16 {name}", ms, llama, B, prompt,
                prompt + 128, lcfg.num_kv_heads * lcfg.head_dim,
                lcfg.num_layers, torch.cuda.max_memory_allocated(), ident)
        run(f"G2 {tag}", g2, slab)
        run(f"G2 {tag} eager", lambda g2=g2: g2(graphs=False), slab)
        if not torch.equal(outs[tag], outs[f"{tag} eager"]):
            raise AssertionError(f"G2 {tag}: the graph and eager ids "
                                 "differ")
        log(f"generate G2 {tag}: graph and eager ids equal; "
            f"{figures['llama ' + tag]['ms']:.4f} against "
            f"{figures['llama ' + tag + ' eager']['ms']:.4f} ms a decode "
            f"step [{ident}]")
    again = llama.generate(lids, max_new_tokens=128, max_seq=prompt + 128,
                           temperature=0.8, top_k=40, seed=3)
    if not torch.equal(again, outs["sampled"]):
        raise AssertionError("G2: the sampled stream is not reproducible")
    same = float((outs["sampled"] == outs["greedy"])[:, prompt:].float()
                 .mean())
    log(f"generate G2: the sampled stream repeats itself; it equals the "
        f"greedy one on {same:.3f} of positions")
    run("G2 two windows", lambda: _two_windows(llama, lids, ident), slab)

    # ---- G4 (llama2_7b): PagedKVCache ----------------------------------
    # 32 bf16 layers amplify the one-ulp differences of the attention
    # outputs further than GPT-2 small's 12 (0.043 of the largest logit
    # on the first run): the limit is 0.1 of it here
    run("G4 llama2_7b paged", lambda: _layout_pass(
        "G4 llama2_7b bf16", llama, lids, 16, [("paged", False),
                                               ("paged", True)], bf16, 0.1,
        ident), ("paged_decode_attention_v1",))
    del llama
    gc.collect()
    torch.cuda.empty_cache()

    # ---- checks: 2-layer full-width f32 --------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = [("slab", False), ("5d", False), ("paged", False)]
    small = init_gpt(dataclasses.replace(cfg, num_layers=2), seed=1,
                     device="cuda").eval()
    check_ids = ids[:2, :64]
    out = run("check GPT-2 small widths", lambda: _layout_pass(
        "GPT-2 small widths 2 layers f32", small, check_ids, 40, kinds,
        torch.float32, 1e-5, ident), slab + GENERATE_ROWS[:2], tc=False)
    _match_cacheless_rows(small, out, 64, "GPT-2 small widths 2 layers f32")
    del small
    small = init_llama(LlamaConfig(num_layers=2), seed=1, device="cuda",
                       dtype=torch.float32)
    out = run("check llama2_7b widths", lambda: _layout_pass(
        "llama2_7b widths 2 layers f32", small, lids[:2, :64], 40,
        kinds, torch.float32, 1e-5, ident), slab + GENERATE_ROWS, tc=False)
    _match_cacheless_rows(small, out, 64, "llama2_7b widths 2 layers f32")
    del small
    torch.cuda.empty_cache()
    log(f"generate: launches {total}")
    for name in GENERATE_ROWS:
        if total[name] <= 0:
            raise AssertionError(f"the generate phase never launched {name}")
    log("generate: " + "; ".join(
        f"{k} {v['ms']:.3f} ms/step {v['tok_s']:.1f} tok/s floor/measured "
        f"{v['floor_ms'] / v['ms']:.4f} peak {v['peak_gib']:.2f} GiB"
        for k, v in figures.items()) + f" [{ident}]")
    log(f"generate: phase took {time.perf_counter() - t_phase:.1f} s")
    return total


def _packed_rows(seq):
    """The rows of the reference kernels whose regime a bf16 packed-route
    call at sequence length ``seq`` replaces: the forward of
    ``_fwd_dispatch`` (whole-row #9 for 512 < S <= 4096 with S % 512 == 0,
    whole-sequence #7 up to 1024, else the tiled #8) and the backward of
    ``_packed_bwd_rule`` (#11 up to 1024, the tiled #10 above)."""
    if 512 < seq <= 4096 and seq % 512 == 0:
        fwd = "causal_flash_fwd_row"
    elif seq <= 1024:
        fwd = "causal_flash_fwd"
    else:
        fwd = "causal_flash_fwd_tiled"
    return fwd, ("causal_flash_bwd" if seq <= 1024
                 else "causal_flash_bwd_tiled")


def _general_rows(seq):
    """The same for ``flash_attention_fused`` on square self-attention: #2
    forward; the fused #5 backward up to S = 1024, the split #6 above."""
    return "flash_attention_fwd", ("flash_attention_bwd_fused" if seq <= 1024
                                   else "flash_attention_bwd_split")


def _no_decay(name):
    return not (name.endswith(".bias") or ".ln_" in name)


def gpt_trainer(cfg, steps, seed=7, peak_lr=6e-4, o2=True):
    """``init_gpt`` on the card, the AdamW recipe of the main path (a
    linear warmup over a quarter of the steps from peak/10 into a cosine
    decay, weight decay 0.01 off biases and norms, global-norm clip 1.0),
    then ``amp.decorate`` O2 (bf16 parameters, f32 master weights in the
    optimizer) unless ``o2`` is False (f32)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import init_gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    model = init_gpt(cfg, seed=seed, device="cuda", dtype=torch.float32)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(peak_lr, steps),
                            max(1, steps // 4), peak_lr / 10, peak_lr)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.01, apply_decay_param_fun=_no_decay,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if o2:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    model.train()
    return model, opt, sched


def train_steps(model, opt, sched, ids, labels, steps):
    """``steps`` eager steps on one fixed batch. Returns (losses, host
    seconds of each step, each ending in a device sync)."""
    import torch

    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach())
    return [float(v) for v in losses], secs


def train_passes(ident, total):
    """The training path at GPT-medium widths, full depth (24 layers), O2
    bf16, random weights from a seed and one fixed random batch repeated:
    T1 the packed route at 12 x 1024 (#9 forward, #11 backward), T2 8 x
    2048 with max_position 2048 (#9, #10), T3 T1's shape on the general
    route (#2, #5), and three short passes that reach the other regimes:
    T4 packed 24 x 512 (#7, #11), T5 packed 1 x 8192 with max_position
    8192 (#8, #10), T6 general 8 x 2048 (#2, #6). Each pass's launches of
    the two flash wrappers are charged to the rows of its regimes; every
    loss must be finite and the last below the first. Reports tokens/s
    (steps after the first), median step ms, peak GiB and MFU as
    ``bench.py`` defines it (6 * params flops a token, and with the causal
    attention's 12 * layers * hidden * S / 2) over the 989 TF/s bf16
    peak."""
    import dataclasses

    import torch

    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models.gpt import gpt2_medium

    tc_ptxas("main training")
    med = gpt2_medium()
    passes = [("T1", med, 12, 1024, 12, True),
              ("T2", dataclasses.replace(med, max_position=2048), 8, 2048, 6,
               True),
              ("T3", med, 12, 1024, 4, False),
              ("T4", med, 24, 512, 3, True),
              ("T5", dataclasses.replace(med, max_position=8192), 1, 8192, 3,
               True),
              ("T6", dataclasses.replace(med, max_position=2048), 8, 2048, 3,
               False)]
    flag = "FLAGS_use_packed_attention"
    saved = get_flags(flag)
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    summary = []
    try:
        for tag, cfg, B, S, steps, packed in passes:
            set_flags({flag: packed})
            rows = _packed_rows(S) if packed else _general_rows(S)
            model, opt, sched = gpt_trainer(cfg, steps)
            g = torch.Generator(device="cuda").manual_seed(S)
            ids = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                device="cuda")
            labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   device="cuda")
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (losses, secs), got = _counted(
                lambda: train_steps(model, opt, sched, ids, labels, steps),
                needs=flash, tc=f"main {tag}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            for wrapper, row in zip(flash, rows):
                total[row] += got.pop(wrapper)
            if any(got.values()):
                raise AssertionError(f"{tag}: launched {got}")
            if not all(map(lambda v: v == v and abs(v) < float("inf"),
                           losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"{tag}: losses {losses} are not "
                                     "finite and falling")
            steady = secs[1:]
            tok_s = B * S * len(steady) / sum(steady)
            n = cfg.num_params()
            attn = 12 * cfg.num_layers * cfg.hidden_size * S // 2
            mfu = tok_s * 6 * n / BF16_FLOPS_PER_S
            mfu_attn = tok_s * (6 * n + attn) / BF16_FLOPS_PER_S
            med_ms = statistics.median(steady) * 1e3
            log(f"main {tag} {'packed' if packed else 'general'} route "
                f"gpt2_medium {cfg.num_layers} layers, max_position "
                f"{cfg.max_position}, O2 bf16, batch {B} x {S}, {steps} "
                f"steps (rows {rows[0]}, {rows[1]}): {tok_s:.1f} tok/s, "
                f"median step {med_ms:.1f} ms (first {secs[0] * 1e3:.1f}), "
                f"peak {peak:.2f} GiB, MFU {mfu:.4f} (with attention "
                f"{mfu_attn:.4f}) [{ident}]")
            log(f"main {tag} losses " + " ".join(f"{v:.4f}" for v in losses))
            summary.append((tag, tok_s, med_ms, peak, mfu))
            del model, opt, sched
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        set_flags(saved)
    log("main training: " + "; ".join(
        f"{t} {a:.1f} tok/s {b:.1f} ms {c:.2f} GiB MFU {d:.4f}"
        for t, a, b, c, d in summary) + f" [{ident}]")


def mixtral_8x7b(**kw):
    """LLaMA-MoE at the published widths of ``mistralai/Mixtral-8x7B-v0.1``
    (its ``config.json``): vocab 32000, hidden 4096, 32 layers, 32 heads
    over 8 kv heads, expert FF 14336, 8 experts, top-2, rope_theta 1e6,
    rms_eps 1e-5, max_position 32768. Built here, not in the package."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    base = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                num_heads=32, num_kv_heads=8, intermediate_size=14336,
                max_position=32768, rope_theta=1e6, rms_eps=1e-5,
                num_experts=8, moe_top_k=2, moe_intermediate_size=14336)
    base.update(kw)
    return LlamaConfig(**base)


def _model_gib(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())
               ) / 2**30


def _peak_pass(torch, run):
    """Peak device memory of ``run()`` (bytes)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _profile_step(eng, tag, steps, ident):
    """``_profile_call`` of one ``eng.step()``; ``steps`` token steps make
    up one engine step."""
    out = _profile_call(eng.step, tag, steps, ident)
    _no_caught_fault(eng, f"profile: {tag}")
    return out


def _profile_call(fn, tag, steps, ident):
    """Host wall time of one ``fn()`` against the device's busy time of
    the next one under torch.profiler, and the top device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"profile: {tag}: wall {wall * 1e3:.3f} ms "
        f"({wall * 1e3 / steps:.3f} ms/token step); device busy "
        f"{busy_ms:.3f} ms under the profiler ({busy_ms / steps:.3f} "
        f"ms/step, idle {max(0.0, 1 - busy_ms / (wall * 1e3)):.0%}); "
        f"{launches} device kernels ({launches / steps:.0f}/step) [{ident}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms, "kernels": launches}


def _profile_pair(tag, make, steps, warm, ident):
    """The same engine step eager and as CUDA graph replays: ``make()``
    gives a fresh engine with its requests queued (the same prompts each
    time); graphs off, then on; ``warm`` steps (admission, the first
    chain or verify step: the graph engine's captures), then
    ``_profile_step``. Logs one row: host wall ms a token step, device
    busy ms a token step, idle share, kernels a token step, eager and
    graph, and the graph engine's capture ms and pool bytes."""
    rows = {}
    for mode in ("eager", "graph"):
        eng = make()
        eng.runner._graphs.enabled = mode == "graph"
        for _ in range(warm):
            eng.step()
        rows[mode] = _profile_step(eng, f"{tag} [{mode}]", steps, ident)
        if mode == "graph":
            note = _graph_note(eng)
        del eng
        gc.collect()

    def fmt(r):
        idle = max(0.0, 1 - r["busy_ms"] / r["wall_ms"])
        return (f"wall {r['wall_ms'] / steps:.3f} ms, busy "
                f"{r['busy_ms'] / steps:.3f} ms, idle {idle:.0%}, "
                f"{r['kernels'] / steps:.0f} kernels a token step")

    log(f"profile row: {tag}: eager {fmt(rows['eager'])}; graph "
        f"{fmt(rows['graph'])}; {note} [{ident}]")
    return rows


def _profile_ordered(tag, make, steps, warm, ident):
    """The dense graph step with its page writes as the card lands them
    (a dense engine's rule) and in order (an MoE engine's,
    ``Engine._ordered_writes``), in one run: what the order costs."""
    rows = {}
    for ordered in (False, True):
        eng = make()
        eng._ordered_writes = ordered
        for _ in range(warm):
            eng.step()
        rows[ordered] = _profile_step(
            eng, f"{tag} [graph, {'ordered' if ordered else 'unordered'} "
            "writes]", steps, ident)
        del eng
        gc.collect()
    off, on = rows[False], rows[True]
    log(f"profile row: ordered page writes, {tag}: busy "
        f"{on['busy_ms'] / steps:.3f} against {off['busy_ms'] / steps:.3f} "
        f"ms a token step ({on['busy_ms'] / off['busy_ms'] - 1:+.2%}), wall "
        f"{on['wall_ms'] / steps:.3f} against {off['wall_ms'] / steps:.3f} "
        f"ms, kernels {on['kernels'] / steps:.0f} against "
        f"{off['kernels'] / steps:.0f} a token step [{ident}]")


def _profile_train(ident):
    """One T1 training step (GPT-medium, O2 bf16, packed route, 12 x 1024)
    after two warm steps: its host wall time against the device's busy
    time in the next step under torch.profiler, and the top device
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models.gpt import gpt2_medium

    set_flags({"FLAGS_use_packed_attention": None})
    cfg = gpt2_medium()
    model, opt, sched = gpt_trainer(cfg, 8)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids, labels = (torch.randint(0, cfg.vocab_size, (12, 1024), generator=g,
                                 device="cuda") for _ in range(2))
    _, secs = train_steps(model, opt, sched, ids, labels, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_steps(model, opt, sched, ids, labels, 1)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    attn_ms = sum(e.self_device_time_total for e in events
                  if "flash_" in e.key) / 1e3
    wall = secs[-1] * 1e3
    mfu = 12 * 1024 / (wall / 1e3) * 6 * cfg.num_params() / BF16_FLOPS_PER_S
    log(f"profile: T1 train step (GPT-medium O2 bf16, packed, 12 x 1024): "
        f"wall {wall:.1f} ms (MFU {mfu:.4f}); device busy {busy_ms:.1f} ms "
        f"under the profiler (idle {max(0.0, 1 - busy_ms / wall):.0%}); "
        f"flash kernels {attn_ms:.2f} ms ({attn_ms / busy_ms:.0%} of the "
        f"device time); {sum(e.count for e in events)} device kernels "
        f"[{ident}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()


# the cuts phase_anatomy makes in csrc/quant_matmul.cu's tensor-core body,
# each an (old text, new text) replacement of the committed source
_NO_WEIGHT = [("      cp_async16(sw + r * WP + col, src, ok);\n",
               "      (void)src;\n")]
_NO_DEQUANT = [(f"        a{t}[{i}] = i8_pair(r{a}, r{b}, {j});\n",
                f"        a{t}[{i}] = r{a};\n")
               for t, i, a, b, j in ((0, 0, 0, 1, 0), (0, 1, 0, 1, 1),
                                     (0, 2, 8, 9, 0), (0, 3, 8, 9, 1),
                                     (1, 0, 0, 1, 2), (1, 1, 0, 1, 3),
                                     (1, 2, 8, 9, 2), (1, 3, 8, 9, 3))]
_NO_MMA = [("          mma_bf16(acc[0][j], a0, b0, b1);\n"
            "          mma_bf16(acc[1][j], a1, b0, b1);\n",
            "          acc[0][j][0] += __uint_as_float(a0[0] ^ a0[3] ^ b0);\n"
            "          acc[1][j][0] += __uint_as_float(a1[0] ^ a1[3] ^ b1);\n")]
ANATOMY = {"the body": [], "no weight bytes": _NO_WEIGHT,
           "no dequant": _NO_DEQUANT, "no MMA": _NO_MMA,
           "no weight bytes, dequant or MMA": _NO_WEIGHT + _NO_DEQUANT
           + _NO_MMA}


def phase_sched(ident):
    """Opt-in: what each scheduler piece does on the card, against the same
    engine without it, in one call and in turns (with, without, without,
    with), ``llama2_7b`` bf16 at full depth on graphs: pre-admission on the
    main pass's items (the wave's method swapped for one that takes
    nothing); the measured boundary cost against the pinned prior on a
    steady decode round (8 x 1024 tokens); ``disaggregate=True`` against
    the plain mixed step on chunked prefill's items, both at the prior.
    Also the device busy time of one profiled mixed step summed from the
    raw trace (``_device_busy_ms``) beside ``key_averages()``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b

    cfg = llama2_7b()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)  # the main phase's first draws

    def plain(specs):
        return [(rng.integers(0, cfg.vocab_size, (n,)), m, t, s)
                for n, m, t, s in specs]

    items1 = plain([(16, 64, 0.0, None), (1024, 32, 0.0, None),
                    (300, 128, 0.8, 11), (64, 96, 0.0, None),
                    (700, 48, 0.8, 12), (128, 128, 0.0, None),
                    (33, 40, 0.0, None), (512, 64, 0.0, None),
                    (900, 32, 0.0, None), (200, 80, 0.0, None)])
    steady = plain([(128, 1024, 0.0, None)] * 8)
    short = plain([(20, 64, 0.0, None), (40, 64, 0.8, 51)])
    long_ = plain([(300, 64, 0.0, None), (600, 64, 0.0, None),
                   (900, 64, 0.8, 52), (1200, 64, 0.0, None),
                   (1600, 64, 0.0, None), (2000, 64, 0.0, None)])

    def engine(**kw):
        return Engine(model, max_slots=8, num_pages=1024, page_size=16,
                      chunk_size=16, **kw)

    def run(tag, eng, items, first=None):
        """Serve ``items`` (``first`` a step ahead); one result row."""
        note = _sched_probe(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = []
        if first:
            reqs = [eng.add_request(p, m, temperature=t, seed=s)
                    for p, m, t, s in first]
            eng.step()
        reqs += [eng.add_request(p, m, temperature=t, seed=s)
                 for p, m, t, s in items]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_done(reqs, (first or []) + items)
        _no_caught_fault(eng, tag)
        ttft = sorted((r._t_first - r._t_arrival) * 1e3 for r in reqs)
        toks = sum(len(r.tokens) for r in reqs)
        log(f"sched {tag}: {toks / wall:.1f} tok/s, TTFT ms median "
            f"{statistics.median(ttft):.1f} max {ttft[-1]:.1f}; "
            f"{_sched_line(eng, note)} [{ident}]")
        row = (toks / wall, statistics.median(ttft), ttft[-1],
               note["steps"], [list(r.tokens) for r in reqs])
        del eng
        gc.collect()
        return row

    def pairs(name, with_, without, items, first=None):
        """``with_`` and ``without`` make the two engines; they serve
        ``items`` in turns: with, without, without, with."""
        rows = {"with": [], "without": []}
        for side in ("with", "without", "without", "with"):
            make = with_ if side == "with" else without
            rows[side].append(run(f"{name} {side}", make(), items, first))
        for side, got in rows.items():
            log(f"sched {name} {side}: tok/s {[round(r[0], 1) for r in got]}"
                f", TTFT median ms {[round(r[1], 1) for r in got]}, max "
                f"{[round(r[2], 1) for r in got]}, steps "
                f"{[r[3] for r in got]} [{ident}]")
        return rows

    def no_preadmit():
        eng = engine()
        eng._preadmit_dispatch = lambda k, exclude=(): ([], None, None,
                                                        None)
        return eng

    # a first engine of the process pays the kernels' loads and cuBLAS's
    # set-up: a run that is not recorded
    run("warm-up", engine(), items1)
    rows = pairs("pre-admission", engine, no_preadmit, items1)
    if rows["with"][0][4] != rows["without"][0][4]:
        log("sched pre-admission: the streams differ with and without "
            "(other co-batching in bf16)")

    pairs("measured cost", engine, lambda: _pin(engine()), steady)
    pairs("disaggregated", lambda: _pin(engine(prefill_chunk=256,
                                               disaggregate=True)),
          lambda: _pin(engine(prefill_chunk=256)), long_, first=short)
    # the raw-trace busy sum against key_averages on one mixed step
    eng = engine(prefill_chunk=256)
    for p, m, t, s in short + long_:
        eng.add_request(p, m, temperature=t, seed=s)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    raw = _device_busy_ms(prof)
    tab = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"sched: one mixed step's device busy {raw:.3f} ms from the raw "
        f"trace, {tab:.3f} ms from key_averages [{ident}]")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


def _pin(eng):
    """``eng`` pinned to the prior boundary cost."""
    eng._cost_pin = eng.DISPATCH_COST_CHUNKS_PRIOR
    return eng


def phase_anatomy(ident):
    """Opt-in: #12's tensor-core body (int8, bf16 x) at the llama2_7b
    gate/up shape, 8 and 40 rows, built again with parts of its work cut
    out of the committed source (``ANATOMY``: the weight copies, the
    dequant, the MMAs, then all three) and timed in this run beside the
    body as committed. A cut's outputs are wrong by design; only its time
    is read. What the body loses without a part is what that part costs
    on the critical path; what is left with all three cut (launch, the x
    staging, the split partials and their sum) is the body's floor."""
    import ctypes
    import torch

    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    src = (build.CSRC / "quant_matmul.cu").read_text()
    out_dir = build.BUILD_DIR / "anatomy"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, cuts) in enumerate(ANATOMY.items()):
        text = src
        for old, new in cuts:
            if old not in text:
                raise AssertionError(f"anatomy: {name!r} finds no {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"cut{i}.cu"
        cu.write_text(text)
        procs[name] = (out_dir / f"cut{i}.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"cut{i}.so"), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise AssertionError(f"anatomy: nvcc failed for {name!r}")
        lib = ctypes.CDLL(str(so))
        lib.quant_matmul.argtypes = build._SIGNATURES["quant_matmul"]
        lib.quant_matmul.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    K, N = 4096, 11008
    for M in (8, 40):
        g = torch.Generator(device="cuda").manual_seed(5)
        wq, sc = weight_quantize(torch.randn(
            (K, N), generator=g, device="cuda") * 0.02, "weight_only_int8")
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        splits, kps = qm.split_plan(M, K, N, False, "tensor_core")
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
        counters = build.arrival_counters(dev, -(-M // 64) * -(-N // 128))
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        times = {}
        for name, lib in libs.items():
            def call(lib=lib):
                build.check(lib.quant_matmul(
                    x.data_ptr(), wq.data_ptr(), sc.data_ptr(), None,
                    ws.data_ptr(), counters.data_ptr(), out.data_ptr(), M, K,
                    N, splits, kps, build.DTYPE_CODES[x.dtype], 0, 1,
                    build.stream_ptr(dev)), f"anatomy {name}")
            times[name] = time_ms(call, reps=30)
        nbytes = x.numel() * 2 + wq.numel() + N * 4 + M * N * 2
        log(f"anatomy quant_matmul int8 {M}x{K}x{N} (splits {splits}, "
            f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms bytes): "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f" [{ident}]")


def phase_drift(ident, B=8, prompt=128, steps=8):
    """Opt-in (not in the default run): where the bf16 logits of the
    decode kernels and their plain versions part with depth. ``llama2_7b``
    at full depth, bf16, random weights (seed 0): a prefill of B=8 random
    128-token prompts on slab caches (#2), then decode steps at
    ``time_step`` = 128, 129, ...

    - Shared inputs, one decode step walked layer by layer: at every layer
      both paths take the SAME hidden state (the kernel path's). The
      decode attention of that layer (#15 and its plain twin ``_slab_ref``
      on the same q and cache) against the f32 attention on the same bf16
      q and cache; the attention module's output and the block's output
      of both paths.
    - Free-running, the same step: each path feeds its own previous output
      on, as the generate checks did: the hidden states' divergence by
      depth.
    - ``steps`` teacher-forced decode steps of the whole model on two
      cache copies, kernels and plain versions: the logits' divergence by
      step.

    Errors are max abs errors over the largest entry of the f32 (or
    plain) value. A bf16 rounding of an output is up to 2**-9 of it."""
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.models.llama import llama2_7b
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(
            1e-30, float(b.float().abs().max()))

    bf16 = torch.bfloat16
    cfg = llama2_7b()
    model = init_llama(cfg, seed=0, device="cuda", dtype=bf16).eval()
    g = torch.Generator(device="cuda").manual_seed(41)
    ids = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                        device="cuda")
    nh, hd = cfg.num_heads, cfg.head_dim
    t = prompt
    lens = torch.full((B,), t + 1, dtype=torch.int32, device="cuda")
    rows = []
    with torch.no_grad():
        logits, caches = model(ids, caches=model.init_caches(
            B, prompt + steps + 1, bf16))
        tok = logits[:, -1:].argmax(-1)
        x = x_free_k = x_free_p = model.model.embed_tokens(tok)
        for i, block in enumerate(model.model.layers):
            attn, cache = block.self_attn, caches[i]
            xn = block.input_layernorm(x)
            q = attn.q_proj(xn).reshape(B, 1, nh, hd)
            k = attn.k_proj(xn).reshape(B, 1, -1, hd)
            v = attn.v_proj(xn).reshape(B, 1, -1, hd)
            q, k = attn._rope(q, k, t, cache)
            c = cache.clone()
            c[0, :, t] = k[:, 0].reshape(B, -1)
            c[1, :, t] = v[:, 0].reshape(B, -1)
            a_k = da.decode_attention_slab(q[:, 0], c, lens)
            a_p = da._slab_ref(q[:, 0], c, lens)
            a_t = da._slab_ref(q[:, 0].float(), c.float(), lens)
            m_k = attn(xn, cache=cache.clone(), time_step=t)[0]
            with _plain_decode():
                m_p = attn(xn, cache=cache.clone(), time_step=t)[0]
            h_k, h_p = x + m_k, x + m_p
            y_k = h_k + block.mlp(block.post_attention_layernorm(h_k))
            y_p = h_p + block.mlp(block.post_attention_layernorm(h_p))
            f_k = block(x_free_k, cache=cache.clone(), time_step=t)[0]
            with _plain_decode():
                f_p = block(x_free_p, cache=cache.clone(), time_step=t)[0]
            rows.append(dict(kernel_truth=rel(a_k, a_t),
                             plain_truth=rel(a_p, a_t),
                             kernel_plain=rel(a_k, a_p),
                             module=rel(m_k, m_p), block=rel(y_k, y_p),
                             free=rel(f_k, f_p)))
            x, x_free_k, x_free_p = y_k, f_k, f_p
        for i, r in enumerate(rows):
            log(f"drift layer {i:2d}: attention kernel vs f32 "
                f"{r['kernel_truth']:.3e}, plain vs f32 "
                f"{r['plain_truth']:.3e}, kernel vs plain "
                f"{r['kernel_plain']:.3e}; attention module "
                f"{r['module']:.3e}; block {r['block']:.3e}; free-running "
                f"hidden state {r['free']:.3e}")
        # teacher-forced whole-model steps on two cache copies
        ck = [c.clone() for c in caches]
        cp = [c.clone() for c in caches]
        step_err = []
        for s in range(steps):
            lk, ck = model(tok, caches=ck, time_step=t + s)
            with _plain_decode():
                lp, cp = model(tok, caches=cp, time_step=t + s)
            step_err.append(rel(lk, lp))
            tok = lp[:, -1:].argmax(-1)
    worst = max(rows, key=lambda r: r["kernel_truth"] - r["plain_truth"])
    log(f"drift: decode attention against f32, worst layer: kernel "
        f"{worst['kernel_truth']:.3e}, plain {worst['plain_truth']:.3e} "
        f"(max over layers: kernel "
        f"{max(r['kernel_truth'] for r in rows):.3e}, plain "
        f"{max(r['plain_truth'] for r in rows):.3e}); shared-input block "
        f"error max {max(r['block'] for r in rows):.3e}; free-running "
        f"hidden state at layers "
        + " ".join(f"{i + 1}: {rows[i]['free']:.3e}" for i in sorted(
            {0, len(rows) // 4 - 1, len(rows) // 2 - 1, len(rows) - 1}))
        + "; logits kernel vs plain by teacher-forced step: "
        + " ".join(f"{e:.3e}" for e in step_err) + f" [{ident}]")
    del model, caches, ck, cp
    torch.cuda.empty_cache()


def phase_profile(ident):
    """Opt-in (not in the default run): where the time goes in one T1
    training step; then at llama2_7b, 8 active slots, bf16, one decode
    chain and one spec-decode verify step, each eager and as CUDA graph
    replays, and one chunked-prefill mixed step (eager: it is not
    captured); then one decode chain with int8 weights and one of the
    16-layer Mixtral-width MoE, each eager and as graph replays; the 7B
    bf16 graph chain also with its page writes in order (the MoE rule)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import llama2_7b
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    _profile_train(ident)
    cfg = llama2_7b()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(3)

    def prompts(n, vocab=cfg.vocab_size):
        return [rng.integers(0, vocab, (n,)) for _ in range(8)]

    def engine(ps, m=None, num_pages=1024, **kw):
        def make():
            eng = Engine(model if m is None else m, max_slots=8,
                         num_pages=num_pages, page_size=16, chunk_size=16,
                         **kw)
            for p in ps:
                eng.add_request(p, 200)
            return eng
        return make

    chain = prompts(512)
    _profile_pair("7B bf16: one 16-step decode chain, ~512-token contexts",
                  engine(chain, max_chain=1), 16, 2, ident)
    _profile_ordered("7B bf16, one 16-step decode chain",
                     engine(chain, max_chain=1), 16, 2, ident)
    # 8 prompts of 2048 tokens stream in 256-token chunks: each mixed step
    # is one [8, 256] forward through the verify kernel
    eng = engine(prompts(2048), prefill_chunk=256)()
    eng.step()
    _profile_step(eng, "one chunked-prefill mixed step, 8 rows x 256 "
                  "prompt tokens over 256 (wall) and 512 (profiled) cached "
                  "tokens", 1, ident)
    del eng
    _profile_pair("7B bf16: one spec verify step, 8 rows x 5 tokens, "
                  "~512-token contexts", engine(prompts(512), spec="ngram",
                                                spec_k=4), 1, 1, ident)
    quantize_for_decode(model, algo="weight_only_int8")
    _profile_pair("7B int8 weights: one 16-step decode chain, ~512-token "
                  "contexts", engine(chain, max_chain=1), 16, 2, ident)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe = init_llama(mixtral_8x7b(num_layers=16), seed=2, device="cuda",
                     dtype=torch.bfloat16)
    _profile_pair("Mixtral widths, 16 layers (MoE): one 16-step decode "
                  "chain, ~512-token contexts",
                  engine(prompts(512, 32000), m=moe, num_pages=512,
                         max_chain=1), 16, 2, ident)
    del moe
    gc.collect()
    torch.cuda.empty_cache()


def _match_cacheless(model, reqs, tag):
    """Each greedy stream against the argmax of the cacheless forward,
    recomputed token by token; a request's comparison stops at the first
    position where the reference's top-2 logit gap is under 1e-4, and at
    least 16 tokens must be compared."""
    import torch

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
                        f"{tag} request {r.rid}: token {compared} is {tok}, "
                        f"the cacheless forward says {want}")
                compared += 1
                seq = torch.cat([seq, seq.new_tensor([tok])])
        if compared < 16:
            raise AssertionError(f"{tag} request {r.rid}: only {compared} "
                                 "tokens compared before a near-tie")
        log(f"greedy {tag}: request {r.rid} (prompt {r.prompt.size}) "
            f"matches the cacheless forward on {compared}/{len(r.tokens)} "
            "tokens")


def identity_f32(model):
    """f32, TF32 off: 12 greedy requests on 4 slots, the queue pre-admitted
    in the chains' shadow, and the same items with the roles split
    (``disaggregate=True``, 64-token chunks): each stream must equal the
    request served alone on a fresh engine. The pool holds every request
    at once: no preemption (a re-prefill computes its tokens another
    way)."""
    import numpy as np

    from paddle_tpu_torch.inference.engine import Engine

    def engine(**kw):
        return Engine(model, max_slots=4, num_pages=256, page_size=16,
                      chunk_size=16, **kw)

    vocab = model.config.vocab_size
    t0 = time.perf_counter()
    r = np.random.default_rng(12)
    items = [(r.integers(0, vocab, (n,)), m, 0.0, None) for n, m in (
        (20, 24), (150, 40), (64, 16), (300, 32), (33, 48), (90, 24),
        (200, 20), (12, 36), (48, 28), (120, 16), (260, 40), (75, 32))]
    alone = [_serve_items(engine(), [it])[0][0].tokens for it in items]
    for tag, kw in (("pre-admission", {}),
                    ("disaggregated", dict(prefill_chunk=64,
                                           disaggregate=True))):
        eng = engine(**kw)
        note = _sched_probe(eng)
        reqs, _ = _serve_items(eng, items, f"identity f32 {tag}")
        if [list(q.tokens) for q in reqs] != [list(a) for a in alone]:
            bad = [q.rid for q, a in zip(reqs, alone) if q.tokens != a]
            raise AssertionError(f"identity f32 {tag}: requests {bad} "
                                 "differ from the request served alone")
        if eng.preemptions:
            raise AssertionError(f"identity f32 {tag}: a preemption")
        if tag == "pre-admission" and not note["preadmitted"]:
            raise AssertionError("identity f32: no request pre-admitted")
        if kw and not note["both_roles"]:
            raise AssertionError("identity f32: no step ran both roles")
        log(f"identity f32 (llama2_7b widths, 2 layers, TF32 off), {tag}: "
            f"12 greedy streams on 4 slots equal each request served alone "
            f"on a fresh engine; {_sched_line(eng, note)}; "
            f"{note['both_roles']} steps ran both roles")
    log(f"identity f32: {time.perf_counter() - t0:.1f} s")


def phase_greedy(ident):
    """2-layer full-width f32: engine greedy streams (plain, prefix cache,
    chunked prefill, n-gram spec; then with int8 weights; then a
    Mixtral-width MoE, plain and chunked) against the argmax of the same
    model's cacheless forward; then ``train_check``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    cfg = LlamaConfig(num_layers=2)
    model = init_llama(cfg, seed=1, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(1)

    def rand(n):
        return rng.integers(0, cfg.vocab_size, (n,))

    def engine(**kw):
        return Engine(model, max_slots=4, num_pages=128, page_size=16,
                      chunk_size=16, **kw)

    reqs, _ = _serve(engine(), [(40, 24, 0.0, None), (150, 24, 0.0, None)],
                     rng, cfg.vocab_size)
    _match_cacheless(model, reqs, "plain")
    identity_f32(model)

    # prefix cache: the second wave splices the first wave's 64-token
    # preamble; one request repeats a whole-page prompt (copy-on-write)
    eng = engine(prefix_cache=True)
    pre = rand(64)
    first = [(np.concatenate([pre, rand(32)]), 24, 0.0, None)]
    second = [(np.concatenate([pre, rand(45)]), 24, 0.0, None),
              (first[0][0], 24, 0.0, None)]
    _serve_items(eng, first)
    reqs, _ = _serve_items(eng, second)
    if eng._pcache.hits < 2:
        raise AssertionError("greedy prefix cache: the second wave missed")
    _match_cacheless(model, reqs, "prefix cache")

    # chunked prefill: prompts of several 32-token chunks
    reqs, _ = _serve(engine(prefill_chunk=32),
                     [(70, 24, 0.0, None), (150, 24, 0.0, None)], rng,
                     cfg.vocab_size)
    _match_cacheless(model, reqs, "chunked")

    # n-gram spec over prompts that repeat a 16-token span
    eng = engine(spec="ngram", spec_k=4)
    reqs, _ = _serve_items(eng, [(np.tile(rand(16), 5), 24, 0.0, None),
                                 (np.tile(rand(16), 8), 24, 0.0, None)])
    if eng._spec.verify_steps < 1:
        raise AssertionError("greedy spec: no verify step ran")
    log(f"greedy spec ngram: {eng._spec.verify_steps} verify steps, "
        f"{eng._spec.drafts_accepted} of {eng._spec.drafts_proposed} drafts "
        "accepted")
    _match_cacheless(model, reqs, "spec ngram")
    del eng

    # the same model with int8 weights: its GEMMs go through #12 at the
    # decode and verify rows (and the cacheless forward's <= 256 rows)
    quantize_for_decode(model, algo="weight_only_int8")
    reqs = _counted(lambda: _serve(
        engine(), [(40, 24, 0.0, None), (150, 24, 0.0, None)], rng,
        cfg.vocab_size), needs=("quant_matmul",))[0][0]
    _match_cacheless(model, reqs, "int8 weights")
    eng = engine(spec="ngram", spec_k=4)
    reqs, _ = _serve_items(eng, [(np.tile(rand(16), 6), 24, 0.0, None)])
    _match_cacheless(model, reqs, "int8 weights spec ngram")
    del eng, model
    torch.cuda.empty_cache()

    # Mixtral widths, 2 layers, capacity factor 4.0 = E/k: no pair drops in
    # the engine's forwards or the cacheless one, so they route alike
    moe = init_llama(mixtral_8x7b(num_layers=2), seed=3, device="cuda",
                     dtype=torch.float32)

    def moe_engine(**kw):
        return Engine(moe, max_slots=4, num_pages=128, page_size=16,
                      chunk_size=16, capacity_factor=4.0, **kw)

    for tag, kw in (("moe", {}), ("moe chunked", dict(prefill_chunk=32))):
        eng = moe_engine(**kw)
        reqs = _counted(lambda: _serve(
            eng, [(40, 24, 0.0, None), (150, 24, 0.0, None)], rng,
            moe.config.vocab_size), needs=("grouped_matmul",))[0][0]
        if eng.moe_stats()["pairs_dropped"]:
            raise AssertionError(f"greedy {tag}: capacity 4.0 dropped pairs")
        _match_cacheless(moe, reqs, tag)
    del eng, moe
    torch.cuda.empty_cache()
    train_check(ident)


def _grads(model, ids, labels, packed, flash):
    """Loss and every parameter's gradient with the given attention flags
    (the packed route; the flash kernels, or ``naive_attention`` when
    ``flash`` is False)."""
    from paddle_tpu_torch.framework.flags import set_flags

    set_flags({"FLAGS_use_packed_attention": packed,
               "FLAGS_use_flash_attention": flash})
    model.zero_grad(set_to_none=True)
    loss = model.loss(ids, labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def _compare_grads(tag, got, want, tol):
    """Fail unless every gradient is within ``tol`` of its largest entry;
    returns the largest such relative error."""
    worst = 0.0
    for name, w in want.items():
        top = max(float(w.abs().max()), 1e-12)
        rel = float((got[name] - w).abs().max()) / top
        if rel > tol:
            raise AssertionError(f"{tag}: {name} off by {rel:.3g} of its "
                                 f"largest entry (limit {tol})")
        worst = max(worst, rel)
    return worst


def train_check(ident):
    """2-layer models at full width, f32 (tf32 off): GPT-medium widths with
    max_position 2048 at S = 1024 and 2048 on the packed and the general
    route, and ``llama2_7b`` widths (``loss``, general route) at the same
    lengths. Loss and every gradient with the kernels are held against
    the same model with plain attention on the card (``naive_attention``:
    ``FLAGS_use_flash_attention`` and the packed route off, autograd
    through PyTorch's own ops): loss within 1e-4, each gradient within
    1e-4 of its largest entry (f32 FMA tiles against cuBLAS, another
    summation order; the first run on the H100 showed at most 7.9e-6). Then three AdamW steps from one start, kernels
    against plain: every parameter within twice the steps' summed learning
    rate (Adam turns a near-zero gradient of either sign into a step of
    the learning rate's size; the K bias's gradient is zero in exact
    arithmetic), and the median difference below 1% of one step."""
    import dataclasses

    import torch

    from paddle_tpu_torch.convert import init_gpt, init_llama
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models.gpt import gpt2_medium
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("FLAGS_use_packed_attention", "FLAGS_use_flash_attention")
    saved = get_flags(names)
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    try:
        cfg = dataclasses.replace(gpt2_medium(), num_layers=2,
                                  max_position=2048)
        model = init_gpt(cfg, seed=5, device="cuda")
        model.train()
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        g = torch.Generator(device="cuda").manual_seed(9)
        for S in (1024, 2048):
            ids, labels = (torch.randint(0, cfg.vocab_size, (2, S),
                                         generator=g, device="cuda")
                           for _ in range(2))
            want_l, want = _grads(model, ids, labels, False, False)
            for packed in (True, False):
                (got_l, got), n = _counted(lambda: _grads(
                    model, ids, labels, packed, True), needs=flash)
                tag = (f"train check GPT-medium widths, 2 layers, f32, 2 x "
                       f"{S}, {'packed' if packed else 'general'} route")
                if abs(got_l - want_l) > 1e-4:
                    raise AssertionError(f"{tag}: loss {got_l} against "
                                         f"plain {want_l}")
                worst = _compare_grads(tag, got, want, 1e-4)
                log(f"{tag}: loss {got_l:.6f} (plain {want_l:.6f}); every "
                    f"gradient within {worst:.3g} of its largest entry; "
                    f"launches fwd {n['flash_attention_fwd']} bwd "
                    f"{n['flash_attention_bwd']}")
        ids, labels = (torch.randint(0, cfg.vocab_size, (2, 1024),
                                     generator=g, device="cuda")
                       for _ in range(2))
        lr_, steps = 1e-4, 3
        for packed in (True, False):
            finals = []
            for flash_on in (True, False):
                model.load_state_dict(start)
                model.zero_grad(set_to_none=True)
                opt = AdamW(learning_rate=lr_,
                            parameters=model.named_parameters(),
                            weight_decay=0.01, apply_decay_param_fun=_no_decay,
                            grad_clip=ClipGradByGlobalNorm(1.0))
                # plain: naive attention on the general route
                set_flags({names[0]: packed and flash_on,
                           names[1]: flash_on})
                for _ in range(steps):
                    model.loss(ids, labels).backward()
                    opt.step()
                    opt.clear_grad()
                finals.append({n: p.detach().clone()
                               for n, p in model.named_parameters()})
            diffs = torch.cat([(finals[0][n] - finals[1][n]).abs().flatten()
                               for n in finals[1]])
            worst, median = float(diffs.max()), float(diffs.median())
            tag = (f"train check: {steps} AdamW steps (lr {lr_}), "
                   f"{'packed' if packed else 'general'} route, kernels "
                   "against plain")
            if worst > 2 * steps * lr_ or median > 0.01 * lr_:
                raise AssertionError(f"{tag}: parameters differ by up to "
                                     f"{worst:.3g} (median {median:.3g})")
            log(f"{tag}: parameters within {worst:.3g} (median "
                f"{median:.3g}, {float((diffs > 1e-6).float().mean()):.2e} "
                "of them beyond 1e-6)")
        del model, start
        torch.cuda.empty_cache()

        lcfg = LlamaConfig(num_layers=2)
        llama = init_llama(lcfg, seed=6, device="cuda", dtype=torch.float32)
        llama.train()
        for S in (1024, 2048):
            ids, labels = (torch.randint(0, lcfg.vocab_size, (1, S),
                                         generator=g, device="cuda")
                           for _ in range(2))
            want_l, want = _grads(llama, ids, labels, False, False)
            (got_l, got), n = _counted(lambda: _grads(
                llama, ids, labels, False, True), needs=flash)
            tag = f"train check llama2_7b widths, 2 layers, f32, 1 x {S}"
            if abs(got_l - want_l) > 1e-4:
                raise AssertionError(f"{tag}: loss {got_l} against plain "
                                     f"{want_l}")
            worst = _compare_grads(tag, got, want, 1e-4)
            log(f"{tag}: loss {got_l:.6f} (plain {want_l:.6f}); every "
                f"gradient within {worst:.3g} of its largest entry; launches "
                f"fwd {n['flash_attention_fwd']} bwd "
                f"{n['flash_attention_bwd']} [{ident}]")
            del want, got
        del llama
        torch.cuda.empty_cache()
    finally:
        set_flags(saved)


# ------------------------------------------------------------- phase 8
LINK_BYTES_PER_S = 64e9  # PCIe Gen5 x16, one way


def _tier_churn(eng, tpls, tail, new, tag, rounds=2, temp=0.0):
    """``rounds`` rounds over the templates ``tpls``, each template with a
    tail of its own per round; a round's requests arrive together (those
    queued behind the slots give their promotions time to land) and run to
    the end, and the next round arrives once the host tier's worker has
    finished its jobs (the seconds it took are the round's settle time).
    Every request must finish with its budget and the engine catch no
    fault. Returns the rounds' requests and settle seconds."""
    import numpy as np

    vocab = eng.cfg.vocab_size
    out, settle = [], []
    for rnd in range(rounds):
        reqs = []
        for t, tpl in enumerate(tpls):
            r = np.random.default_rng(1000 + 100 * rnd + t)
            prompt = np.concatenate([tpl, r.integers(0, vocab, (tail,))])
            reqs.append(eng.add_request(
                prompt, new, temperature=temp,
                seed=77 + 100 * rnd + t if temp else None))
        eng.run()
        out.append(reqs)
        t_s = time.perf_counter()
        if eng.kv_tier is not None:
            _wait_for(eng.kv_tier.idle, 300, f"{tag}: the tier's worker")
            eng._cache.drain_tier()
        settle.append(time.perf_counter() - t_s)
    for reqs in out:
        for r in reqs:
            if r.failed or not r.done or len(r.tokens) != new:
                raise AssertionError(
                    f"{tag}: request {r.rid} ended {r.state} reason="
                    f"{r.failure_reason} with {len(r.tokens)}/{new} tokens")
    _no_caught_fault(eng, tag)
    return out, settle


def _promoted_digest_check(eng):
    """Wrap ``eng``'s host tier so that every page it promotes is hashed
    (blake2b over its device bytes, k, v, scale per layer) right after the
    restore and held to the digest taken at its demotion. Returns the
    count of pages checked (a dict the wrapper fills)."""
    import hashlib

    import torch

    from paddle_tpu_torch.inference.kv_tier import page_bytes

    tier = eng.kv_tier
    real = tier._land_promotions
    state = {"pages": 0}

    def land(promotes):
        want = {id(ent): tier._digest.get(hslot)
                for ent, hslot, *_ in promotes}
        real(promotes)
        torch.cuda.synchronize()
        flat = eng._cache.pages_flat()
        for ent, *_ in promotes:
            if ent.tier != "hbm" or not ent.page:
                continue  # no page for it: it stayed on the host
            d = hashlib.blake2b(digest_size=16)
            for b in flat:
                d.update(page_bytes(b[ent.page].cpu()))
            if d.digest() != want[id(ent)]:
                raise AssertionError(
                    f"tier: promoted page {ent.page} differs from its bytes "
                    "at demotion")
            state["pages"] += 1

    tier._land_promotions = land
    return state


def _copy_summary(tier, tag, ident):
    """Log the tier's timed copies, each way, beside the host link's bound
    (bytes over ``LINK_BYTES_PER_S``)."""
    for way in ("d2h", "h2d"):
        waves = [w for w in tier.copy_log if w[0] == way]
        if not waves:
            raise AssertionError(f"{tag}: no {way} copy was timed")
        pages = sum(w[1] for w in waves)
        nbytes = sum(w[2] for w in waves)
        ms = sum(w[3] for w in waves)
        bound = nbytes / LINK_BYTES_PER_S * 1e3
        log(f"{tag}: {way} {len(waves)} waves, {pages} pages, "
            f"{nbytes / 2**20:.1f} MiB in {ms:.3f} ms device time = "
            f"{nbytes / ms / 1e6:.2f} GB/s; link bound {bound:.3f} ms "
            f"at 64 GB/s ({ms / bound:.2f}x); a wave: median "
            f"{statistics.median(w[3] for w in waves):.3f} ms for "
            f"{statistics.median(w[1] for w in waves)} pages, max "
            f"{max(w[3] for w in waves):.3f} ms [{ident}]")


def _ttft_ms(reqs):
    return statistics.median((r._t_first - r._t_arrival) * 1e3
                             for r in reqs)


def _two_waves(eng, shared, tails, new, tag, temp=0.0):
    """Wave 1 registers ``shared`` + a tail each, wave 2 splices it (other
    tails); every request must finish with its budget. Returns the
    requests."""
    import numpy as np

    reqs = []
    for wave in range(2):
        items = [(np.concatenate([shared, t]), new, temp,
                  11 + i if temp else None)
                 for i, t in enumerate(tails[wave])]
        reqs += _serve_items(eng, items, tag)[0]
    return reqs


TIER_LAYERS = 16


def phase_tier(ident):
    """``llama2_7b`` widths at ``TIER_LAYERS`` of its 32 layers, bf16,
    random weights from a seed: the host KV tier under churn, the integrity sentinel (audit,
    faults, strict) and the KV handoff over ``/v1/kv``; then the f32
    identities at two layers (the module docstring, phase 8). Returns the
    launches by kernel row."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.inference.integrity import (IntegritySentinel,
                                                      page_checksums)
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.nn.quant import quantize_for_decode
    from paddle_tpu_torch.serving.replica import (decode_kv_payload,
                                                  encode_kv_payload)

    gc.collect()
    torch.cuda.empty_cache()
    # llama2_7b's widths at TIER_LAYERS of its 32 layers: the depth cut
    # that makes room for the pp phase in the run's time limit (a page,
    # the weight baseline and the handoff's payload scale with it)
    cfg = LlamaConfig(num_layers=TIER_LAYERS)
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"tier: llama2_7b widths, {TIER_LAYERS} of 32 layers, bf16 "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    vocab = cfg.vocab_size
    total = {name: 0 for name in KERNELS}
    vanilla = ("paged_decode_attention", "flash_attention_fwd")
    spliced = vanilla + ("paged_verify_attention",)

    def run_pass(tag, run, needs, tc=True):
        t_pass = time.perf_counter()
        out, got = _counted(run, needs, tc=tag if tc else None)
        log(f"{tag}: launches {got}; {time.perf_counter() - t_pass:.1f} s")
        if got.pop("flash_attention_bwd"):
            raise AssertionError(f"{tag}: serving launched the backward")
        for name, n in got.items():
            total[name] += n
        gc.collect()  # an engine and its runner hold each other
        torch.cuda.empty_cache()
        return out

    def integrity_counts():
        return {k: {t: _metric(f"paddle_tpu_integrity_{k}_total",
                               {"target": t})
                    for t in ("weights", "kv", "shadow", "sentinel",
                              "kv_tier", "kv_handoff")}
                for k in ("checks", "failures")}

    def delta(before):
        now = integrity_counts()
        return {k: {t: now[k][t] - before[k][t] for t in now[k]}
                for k in now}

    # ---- (a) the tier under churn: 16 templates of 512 tokens (512
    # pages, 2 GiB) against a 256-page pool (1 GiB) and a 512-page pinned
    # slab (2 GiB); 32-token tails, 32 new tokens, greedy, two rounds
    NT, TLEN, TAIL, NEW, POOL, HOST, PS = 16, 512, 32, 32, 256, 512, 16
    page_bytes_ = (2 * cfg.num_layers * PS * cfg.num_kv_heads
                   * cfg.head_dim * 2)
    tpls = [np.random.default_rng(300 + i).integers(0, vocab, (TLEN,))
            for i in range(NT)]
    log(f"tier churn: {NT} templates x {TLEN} tokens "
        f"({NT * TLEN // PS} pages, {NT * TLEN // PS * page_bytes_ / 2**30:.1f}"
        f" GiB), {TAIL}-token tails, {NEW} new tokens, greedy, 2 rounds of "
        f"{NT} requests arriving together; pool {POOL} pages "
        f"({POOL * page_bytes_ / 2**30:.1f} GiB), kv_host_pages={HOST} "
        f"({HOST * page_bytes_ / 2**30:.1f} GiB pinned), 4 slots, a page "
        f"{page_bytes_ / 2**20:.0f} MiB")

    def tier_engine(hp):
        return Engine(model, max_slots=4, num_pages=POOL + 1, page_size=PS,
                      chunk_size=16, prefix_cache=True, kv_host_pages=hp)

    def churn(tag, hp, check=False):
        """Two churn rounds on a fresh engine (``kv_host_pages=hp``), then
        one request on template 0, which the churn has moved off the card:
        with the tier its chain is promoted first (the promote time), then
        the request splices it; without, it recomputes. Returns (round 2's
        median TTFT, the one request's TTFT, the promote ms)."""
        t_build = time.perf_counter()
        eng = tier_engine(hp)
        build_s = time.perf_counter() - t_build
        state = _promoted_digest_check(eng) if check else None
        try:
            rounds, settle = _tier_churn(eng, tpls, TAIL, NEW, tag)
            r2 = rounds[1]
            ttft = _ttft_ms(r2)
            line = (f"{tag}: built in {build_s:.2f} s; round 2 TTFT median "
                    f"{ttft:.1f} ms, max "
                    f"{max((r._t_first - r._t_arrival) * 1e3 for r in r2):.1f};"
                    f" prefix hits {eng._pcache.hits} misses "
                    f"{eng._pcache.misses}, cached tokens "
                    f"{eng._cache.cached_tokens}")
            tier = eng.kv_tier
            if tier is not None:
                # how long the worker ran on after each round's last
                # request (its digests are host work)
                line += ("; the worker's backlog cleared "
                         + ", ".join(f"{x:.2f}" for x in settle)
                         + " s after rounds 1, 2")
                waits = [r._t_promote_wait * 1e3 for r in r2]
                line += (f"; demotions {tier.demotions}, promotions "
                         f"{tier.promotions}, promote requests (hits) "
                         f"{tier.hits}, drops {tier.drops}; promote_wait "
                         f"round 2 median {statistics.median(waits):.2f} "
                         f"ms, max {max(waits):.2f}, sum {sum(waits):.1f}")
            log(line + f" [{ident}]")
            # template 0 once more, promoted first where there is a tier
            tpl = tpls[0]
            prompt = np.concatenate([tpl, np.random.default_rng(7).integers(
                0, vocab, (TAIL,))])
            _, on_card, demoted = eng._pcache.lookup(tpl, touch=False,
                                                     tiers=True)
            t_p = time.perf_counter()
            if tier is not None and demoted:
                tier.request_promote(demoted)
                tier.await_promotions(demoted, budget_s=120.0)
                torch.cuda.synchronize()
            promote_ms = (time.perf_counter() - t_p) * 1e3
            after = eng._pcache.lookup(tpl, touch=False)[1]
            hits0 = eng._pcache.hits
            req = _serve_items(eng, [(prompt, NEW, 0.0, None)], tag)[0][0]
            one = (req._t_first - req._t_arrival) * 1e3
            spliced = eng._pcache.hits > hits0
            log(f"{tag}: template 0 after the churn: {on_card} of {TLEN} "
                f"tokens on the card, {len(demoted)} pages on the host; "
                + (f"promoted in {promote_ms:.1f} ms ({after} tokens on "
                   "the card after); " if tier is not None else "")
                + f"a request on it (+{TAIL} tokens) TTFT {one:.1f} ms, "
                f"{'spliced' if spliced else 'recomputed'} [{ident}]")
            if check:
                if not tier.demotions or not tier.promotions:
                    raise AssertionError(f"{tag}: the tier never engaged")
                if not state["pages"] or after != TLEN or not spliced:
                    raise AssertionError(
                        f"{tag}: template 0 did not come back whole "
                        f"({after} tokens, {state['pages']} pages checked)")
                log(f"{tag}: {state['pages']} promoted pages, each equal "
                    "byte for byte (blake2b) to its demotion")
                _copy_summary(tier, tag, ident)
            return ttft, one, promote_ms if tier is not None else None
        finally:
            eng._cache.shutdown_tier()

    ttft = {}
    ttft["check"] = run_pass("tier churn", lambda: churn(
        "tier churn (digest check)", HOST, check=True), spliced)
    for i, hp in enumerate((0, HOST, HOST, 0)):
        tag = f"tier churn {'on' if hp else 'off'} #{i}"
        ttft[tag] = run_pass(tag, lambda hp=hp, tag=tag: churn(tag, hp),
                             vanilla)
    runs = list(ttft)[1:]
    log("tier churn, in turns off/on/on/off: round 2 TTFT median ms "
        + ", ".join(f"{ttft[k][0]:.1f}" for k in runs)
        + "; template 0's request TTFT ms "
        + ", ".join(f"{ttft[k][1]:.1f}" for k in runs)
        + "; its promotion ms (tier on) "
        + ", ".join(f"{ttft[k][2]:.1f}" for k in runs if ttft[k][2])
        + f" (the digest-check run: {ttft['check'][0]:.1f}, "
        f"{ttft['check'][1]:.1f}, {ttft['check'][2]:.1f}) [{ident}]")

    # ---- (b) integrity audit: weight baseline, probes, checksum waves,
    # and tok/s with the audit on and off, in turns
    shared = np.random.default_rng(41).integers(0, vocab, (512,))
    tails = [[np.random.default_rng(50 + 10 * w + i).integers(
        0, vocab, (32,)) for i in range(4)] for w in range(2)]
    audit_spec = "audit"  # the preset: a weight probe every 16 steps

    def audit_run(tag, on):
        eng = Engine(model, max_slots=8, num_pages=512, page_size=PS,
                     chunk_size=16, prefix_cache=True, max_chain=2)
        if on:  # the sentinel is built last, as Engine.__init__ builds it
            t_b = time.perf_counter()
            eng._integrity = IntegritySentinel.build(eng, audit_spec)
            torch.cuda.synchronize()
            base_s = time.perf_counter() - t_b
            nbytes = sum(p.numel() * p.element_size() for p in eng._params)
            log(f"{tag}: weight baseline {nbytes / 1e9:.2f} GB, "
                f"{len(eng._integrity._probe_targets)} blocks, digested in "
                f"{base_s:.2f} s ({nbytes / base_s / 1e9:.2f} GB/s) "
                f"[{ident}]")
        before = integrity_counts()
        t_r = time.perf_counter()
        reqs = _two_waves(eng, shared, tails, 64, tag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_r
        toks = sum(len(r.tokens) for r in reqs)
        d = delta(before)
        log(f"{tag}: {toks / wall:.1f} tok/s ({toks} tokens in {wall:.3f} "
            f"s); integrity checks {d['checks']}, failures {d['failures']}"
            f" [{ident}]")
        if any(d["failures"].values()):
            raise AssertionError(f"{tag}: a clean run failed a check")
        if on and not d["checks"]["kv"]:
            raise AssertionError(f"{tag}: no kv check ran")
        return eng, toks / wall

    def audit_probes(eng):
        ig = eng._integrity
        targets = ig._probe_targets
        times = []
        for _ in range(24):
            i, b = targets[ig._probe_cursor % len(targets)]
            a, e, _ = ig._weight_base[i][1][b]
            t_p = time.perf_counter()
            if not ig.audit_weights_once():
                raise AssertionError("integrity: a clean probe failed")
            times.append(((time.perf_counter() - t_p) * 1e3,
                          (e - a) * eng._params[i].element_size()))
        big = max(times, key=lambda t: t[1])
        log(f"integrity audit: one weight probe (24 consecutive): median "
            f"{statistics.median(t[0] for t in times):.2f} ms, max "
            f"{max(t[0] for t in times):.2f}; the largest block "
            f"({big[1] / 2**20:.1f} MiB) {big[0]:.2f} ms [{ident}]")
        pages = sorted(eng._pcache._by_page)[:32]
        if len(pages) < 32:
            raise AssertionError("integrity: fewer than 32 cached pages")
        flat = eng._cache.pages_flat()
        for w in (1, 8, 32):
            idx = torch.tensor(pages[:w], device=eng.device)
            dev = time_ms(lambda idx=idx: page_checksums(flat, idx))
            t_h = time.perf_counter()
            ig._page_sums(pages[:w])
            host = (time.perf_counter() - t_h) * 1e3
            log(f"integrity audit: checksum wave of {w} pages "
                f"({w * page_bytes_ / 2**20:.0f} MiB): {dev:.3f} ms device, "
                f"{host:.3f} ms host with the fetch; bytes bound "
                f"{w * page_bytes_ / HBM_BYTES_PER_S * 1e3:.3f} ms [{ident}]")
        p = pages[5]
        want = int(page_checksums(flat, torch.tensor([p],
                                                    device=eng.device))[0])
        others = [q for q in pages if q != p]
        for w in (1, 2, 4, 8, 16, 32):
            for at in sorted({0, w // 2, w - 1}):
                idx = others[:at] + [p] + others[at:w - 1]
                got = page_checksums(flat, torch.tensor(idx, device=eng.device))
                if int(got[at]) != want:
                    raise AssertionError(
                        f"integrity: page {p}'s checksum at width {w} "
                        f"position {at} differs from width 1")
        cpu = int(page_checksums([b.cpu() for b in flat],
                                 torch.tensor([p]))[0])
        if cpu != want:
            raise AssertionError("integrity: the card's checksum is not the "
                                 "CPU's")
        log("integrity audit: a page's checksum is the same in waves of "
            "widths 1, 2, 4, 8, 16, 32 at every position tried, and equal to "
            "the CPU's")

    tps = {}
    for i, on in enumerate((False, True, True, False)):
        tag = f"integrity audit {'on' if on else 'off'} #{i}"

        def go(tag=tag, on=on):
            before = integrity_counts()
            eng, tps[tag] = audit_run(tag, on)
            if on and i == 2:
                audit_probes(eng)
                d = delta(before)
                if not d["checks"]["weights"] or any(d["failures"].values()):
                    raise AssertionError(f"{tag}: weight checks {d}")

        run_pass(tag, go, spliced)

    log("integrity audit: tok/s in turns off/on/on/off: "
        + ", ".join(f"{v:.1f}" for v in tps.values()) + f" [{ident}]")

    # ---- (c) faults: bit-flip-kv; bit-flip-weight behind the ApiServer;
    # the same weight flip on int8 weights comes after (e)
    def kv_fault():
        eng = Engine(model, max_slots=8, num_pages=512, page_size=PS,
                     chunk_size=16, prefix_cache=True,
                     fault_plan="bit-flip-kv:at=1",
                     integrity={"mode": "audit", "weight_audit_every": 0})
        bad = []
        real = eng._contain_kv_corruption
        eng._contain_kv_corruption = lambda b: (bad.append(list(b)),
                                                real(b))
        before = integrity_counts()
        _two_waves(eng, shared, tails, 16, "fault bit-flip-kv")
        d = delta(before)
        if eng._fi.fired("bit-flip-kv") != 1 or not bad \
                or d["failures"]["kv"] < 1:
            raise AssertionError(f"fault bit-flip-kv: not detected ({d})")
        log(f"fault bit-flip-kv: fired once, pages {bad} failed their "
            f"checksum and were invalidated with their descendants; prefix "
            f"misses {eng._pcache.misses}, every request finished; kv "
            f"checks {d['checks']['kv']:.0f}, failures "
            f"{d['failures']['kv']:.0f}")

    run_pass("fault bit-flip-kv", kv_fault, vanilla)

    def flip_recorder(eng, restore):
        """Record what ``bit-flip-weight`` changes; ``restore`` keeps a copy
        of the parameter to put back (the flip writes the shared model)."""
        ig = eng._integrity
        real = ig._flip_weight_bit
        rec = {}

        def flip(i, a, e, fi):
            p = eng._params[i]
            rec.update(i=i, dtype=p.dtype, shape=tuple(p.shape),
                       saved=p.detach().clone() if restore else None)
            real(i, a, e, fi)
            rec["changed"] = int((int_view(p) != int_view(rec["saved"]))
                                 .sum()) if restore else None

        ig._flip_weight_bit = flip
        return rec

    def int_view(t):
        from paddle_tpu_torch.inference.runner import int_words

        return int_words(t.detach())

    def weight_fault():
        import urllib.error

        eng = Engine(model, max_slots=4, num_pages=256, page_size=PS,
                     chunk_size=16, fault_plan="bit-flip-weight:at=1",
                     integrity={"mode": "audit", "weight_audit_every": 1})
        rec = flip_recorder(eng, restore=True)
        before = integrity_counts()
        api = _Api(eng, grace_s=5.0)
        try:
            api.frontend.submit(shared[:64], 64)
            ready, t_end = None, time.perf_counter() + 300
            while time.perf_counter() < t_end:
                try:
                    status, ready = api.get("/readyz")
                except urllib.error.HTTPError as e:
                    status, ready = e.code, json.loads(e.read())
                if status == 503 and ready.get("quarantined"):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("fault bit-flip-weight: /readyz never "
                                     f"reported the quarantine ({ready})")
        finally:
            api.close(check=False)
            if "saved" in rec:
                with torch.no_grad():
                    eng._params[rec["i"]].copy_(rec["saved"])
        d = delta(before)
        if not eng._watchdog.quarantined or d["failures"]["weights"] < 1 \
                or rec["changed"] != 1:
            raise AssertionError(f"fault bit-flip-weight: {rec}, {d}")
        log(f"fault bit-flip-weight: one bit of parameter {rec['i']} "
            f"({rec['dtype']}, {rec['shape']}) flipped in place; the audit "
            f"failed it ({d['failures']['weights']:.0f}), the engine is "
            f"quarantined and /readyz over the ApiServer answers 503 "
            f"{ready}; the bit put back")

    run_pass("fault bit-flip-weight", weight_fault, ("flash_attention_fwd",))

    # ---- (d) strict: the shadow every 4 steps on clean greedy streams
    def strict():
        eng = Engine(model, max_slots=8, num_pages=1024, page_size=PS,
                     chunk_size=16, max_chain=1,
                     integrity={"mode": "strict", "shadow_every": 4,
                                "weight_audit_every": 0})
        ig = eng._integrity
        real = ig.shadow_check
        margins = []

        def shadow():
            ok = real()
            if ok is not None:
                margins.append((ig.last_margin, ok))
            return ok

        ig.shadow_check = shadow
        rng = np.random.default_rng(61)
        reqs = [eng.add_request(rng.integers(0, vocab, (n,)), 512)
                for n in (64, 200, 333, 512, 700, 900, 1024, 128)]
        eng.run()
        failed = [r.rid for r in reqs if r.failed]
        if any(r.failure_reason not in (None, "integrity") for r in reqs) \
                or not all(r.done for r in reqs):
            raise AssertionError("integrity strict: a request ended other "
                                 "than by the shadow")
        _no_caught_fault(eng, "integrity strict")
        if not margins:
            raise AssertionError("integrity strict: no shadow check ran")
        rel = [m / s for (m, s), _ in margins]
        tol = ig.cfg.shadow_tol
        log(f"integrity strict: {len(margins)} shadow checks on clean bf16 "
            f"greedy streams, margin / logit scale median "
            f"{statistics.median(rel):.4f}, max {max(rel):.4f} against "
            f"shadow_tol {tol}; {sum(not ok for _, ok in margins)} over it, "
            f"requests failed by the shadow {failed} [{ident}]")

    run_pass("integrity strict", strict, vanilla)

    # ---- (e) the handoff: two engines, each behind its own ApiServer
    def handoff():
        P = np.random.default_rng(71).integers(0, vocab, (512,))
        ptoks = [int(t) for t in P]

        def make():
            return Engine(model, max_slots=4, num_pages=257, page_size=PS,
                          chunk_size=16, prefix_cache=True)

        A, B, C = _Api(make()), _Api(make()), _Api(make())
        try:
            A.complete({"prompt": ptoks, "max_tokens": 16})
            t_x = time.perf_counter()
            st, exp, nbytes = A.post_raw("/v1/kv", json.dumps(
                {"op": "export", "tokens": ptoks}).encode())
            export_s = time.perf_counter() - t_x
            if st != 200 or not exp["payload"]:
                raise AssertionError(f"handoff: export answered {st}")
            t_c = time.perf_counter()
            pay = A.frontend.export_kv(ptoks, timeout=300)
            capture_s = time.perf_counter() - t_c
            t_e = time.perf_counter()
            enc = encode_kv_payload(pay)
            encode_s = time.perf_counter() - t_e
            body = json.dumps({"op": "import", "payload": exp["payload"]})
            t_j = time.perf_counter()
            json.loads(body)
            parse_s = time.perf_counter() - t_j
            t_d = time.perf_counter()
            dec = decode_kv_payload(enc)
            decode_s = time.perf_counter() - t_d
            t_i = time.perf_counter()
            st, got, _ = B.post_raw("/v1/kv", body.encode())
            import_s = time.perf_counter() - t_i
            if st != 200 or got["adopted"] != len(pay["pages"]):
                raise AssertionError(f"handoff: import answered {st} {got}")
            t_a = time.perf_counter()
            n = C.frontend.import_kv(dec, timeout=300)
            torch.cuda.synchronize()
            adopt_s = time.perf_counter() - t_a
            if n != len(pay["pages"]):
                raise AssertionError(f"handoff: adopt took {n} pages")
            # B spliced the adopted pages; a fresh engine recomputes
            ttft_b, _ = B.first_token_s(P, 16)
            D = _Api(make())
            try:
                ttft_d, _ = D.first_token_s(P, 16)
            finally:
                D.close()
            if B.engine._pcache.hits < 1:
                raise AssertionError("handoff: B's admission missed")
            mb = nbytes / 2**20
            log(f"handoff: {len(pay['pages'])} pages ({pay['nbytes'] / 2**20:.0f}"
                f" MiB raw), export reply {mb:.1f} MB of JSON; export POST "
                f"{export_s * 1e3:.0f} ms (capture {capture_s * 1e3:.0f}, "
                f"encode {encode_s * 1e3:.0f}); import POST {import_s * 1e3:.0f}"
                f" ms (JSON parse {parse_s * 1e3:.0f}, decode "
                f"{decode_s * 1e3:.0f}, adopt {adopt_s * 1e3:.0f}, the rest "
                f"{(import_s - parse_s - decode_s - adopt_s) * 1e3:.0f} the "
                f"transfer); B's TTFT with adoption {ttft_b * 1e3:.1f} ms, a "
                f"fresh engine's {ttft_d * 1e3:.1f} ms [{ident}]")
        finally:
            for api in (A, B, C):
                api.close()

    run_pass("handoff", handoff, spliced)

    # ---- (c, int8) the weight flip on #12's buffers: the probe is
    # pointed at the first int8 weight, so the flip lands there
    def int8_fault():
        quantize_for_decode(model, algo="weight_only_int8")
        eng = Engine(model, max_slots=4, num_pages=256, page_size=PS,
                     chunk_size=16, max_chain=1,
                     fault_plan="bit-flip-weight:at=1",
                     integrity={"mode": "audit", "weight_audit_every": 1})
        ig = eng._integrity
        ig._probe_cursor = next(
            k for k, (i, _) in enumerate(ig._probe_targets)
            if eng._params[i].dtype == torch.int8)
        rec = flip_recorder(eng, restore=False)
        before = integrity_counts()
        req = eng.add_request(shared[:64], 128)
        eng.run()  # returns at the quarantine
        d = delta(before)
        if not eng._watchdog.quarantined or rec.get("dtype") != torch.int8 \
                or d["failures"]["weights"] < 1 or req.done:
            raise AssertionError(f"fault bit-flip-weight int8: {rec} {d}")
        log(f"fault bit-flip-weight, int8 weights: parameter {rec['i']} "
            f"(int8, {rec['shape']}, read by #12) flipped in place; the audit "
            f"failed it, the engine is quarantined after "
            f"{len(req.tokens)} tokens and mints no more")

    run_pass("fault bit-flip-weight int8", int8_fault, ("quant_matmul",))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tier_identity_f32(ident, total)
    return total


def tier_identity_f32(ident, total):
    """f32, TF32 off, two layers at ``llama2_7b``'s widths: the tier on
    under churn, the audit with ``bit-flip-kv``, and a handed-off prompt
    must give the plain run's streams (tier off, integrity off, B's own
    recompute), greedy and sampled."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = init_llama(LlamaConfig(num_layers=2), seed=5, device="cuda",
                           dtype=torch.float32)
        vocab = model.config.vocab_size
        tpls = [np.random.default_rng(90 + i).integers(0, vocab, (256,))
                for i in range(8)]

        def engine(**kw):
            return Engine(model, max_slots=2, num_pages=65, page_size=16,
                          chunk_size=16, prefix_cache=True, **kw)

        def counted(tag, run, needs=("paged_decode_attention",
                                     "flash_attention_fwd")):
            got = _counted(run, needs)[1]
            got.pop("flash_attention_bwd")
            for name, n in got.items():
                total[name] += n

        for temp in (0.0, 0.8):
            kind = "sampled" if temp else "greedy"
            out = {}

            def churn(hp, temp=temp, out=out):
                eng = engine(kv_host_pages=hp)
                try:
                    rounds = _tier_churn(eng, tpls, 16, 24,
                                         f"identity f32 tier {hp}",
                                         temp=temp)[0]
                    out[hp] = [list(r.tokens) for rs in rounds for r in rs]
                    if hp:
                        out["tier"] = (eng.kv_tier.demotions,
                                       eng.kv_tier.promotions)
                finally:
                    eng._cache.shutdown_tier()

            counted(f"identity f32 tier {kind}", lambda: (churn(256),
                                                          churn(0)))
            if out[256] != out[0]:
                raise AssertionError(f"identity f32 tier {kind}: the tier's "
                                     "streams differ from the plain run's")
            dem, pro = out["tier"]
            if not dem or not pro:
                raise AssertionError(f"identity f32 tier {kind}: the tier "
                                     f"never engaged ({dem}, {pro})")
            log(f"identity f32 (llama2_7b widths, 2 layers, TF32 off), tier "
                f"on under churn, {kind}: 16 streams equal the tier-off run "
                f"({dem} demotions, {pro} promotions)")

        shared = np.random.default_rng(95).integers(0, vocab, (128,))
        tails = [[np.random.default_rng(96 + 10 * w + i).integers(
            0, vocab, (20,)) for i in range(2)] for w in range(2)]
        for temp in (0.0, 0.8):
            kind = "sampled" if temp else "greedy"
            got = {}

            def kv(temp=temp, got=got):
                eng = engine(fault_plan="bit-flip-kv:at=1",
                             integrity={"mode": "audit",
                                        "weight_audit_every": 0})
                got["audit"] = [list(r.tokens) for r in _two_waves(
                    eng, shared, tails, 24, "identity f32 audit", temp)]
                if eng._fi.fired("bit-flip-kv") != 1 \
                        or eng._integrity.last_error is None:
                    raise AssertionError("identity f32 audit: the flip was "
                                         "not detected")
                got["plain"] = [list(r.tokens) for r in _two_waves(
                    Engine(model, max_slots=2, num_pages=65, page_size=16,
                           chunk_size=16), shared, tails, 24,
                    "identity f32 plain", temp)]

            counted(f"identity f32 audit {kind}", kv)
            if got["audit"] != got["plain"]:
                raise AssertionError(f"identity f32 audit {kind}: streams "
                                     "differ from the plain run's")
            log(f"identity f32, integrity audit with bit-flip-kv, {kind}: "
                "detected, and 4 streams equal the plain run's")

        P = np.random.default_rng(97).integers(0, vocab, (256,))
        for temp in (0.0, 0.8):
            kind = "sampled" if temp else "greedy"
            got = {}

            def handoff(temp=temp, got=got):
                a = engine()
                a.add_request(P, 8)
                a.run()
                pay = a._cache.export_handoff(P)
                b = engine()
                if b.adopt_kv_pages(pay) != len(pay["pages"]):
                    raise AssertionError("identity f32 handoff: not adopted")
                for key, eng in (("b", b), ("own", engine())):
                    r = eng.add_request(P, 24, temperature=temp, seed=5)
                    eng.run()
                    got[key] = list(r.tokens)
                if b._pcache.hits != 1:
                    raise AssertionError("identity f32 handoff: B missed")

            counted(f"identity f32 handoff {kind}", handoff,
                    ("paged_decode_attention", "flash_attention_fwd",
                     "paged_verify_attention"))
            if got["b"] != got["own"]:
                raise AssertionError(f"identity f32 handoff {kind}: B's "
                                     "stream differs from its recompute")
            log(f"identity f32, handoff {kind}: B's stream from the adopted "
                "pages equals B's own recompute")
        del model
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ------------------------------------------------------------ phase 9
def _warm_graphs(eng):
    """Capture ``eng``'s decode token step for every slot bucket, greedy
    and sampled, at depth 1 (one graph serves every depth): no measured
    window or restart then pays a first capture. The dummy chains write
    only to the trash page."""
    import torch

    from paddle_tpu_torch.inference.engine import _pow2ceil

    nb_full = _pow2ceil(eng.max_slots)
    for nb in [1 << i for i in range(nb_full.bit_length())]:
        for sampling in (False, True):
            def z(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=eng.device)
            eng.runner.get_decode(nb, 1, sampling)(
                z((nb, eng.max_pages_per_seq), torch.int32),
                z((nb,), torch.int32), z((nb,), torch.int64),
                z((nb,), torch.float32), z((nb, 2), torch.int64))
    torch.cuda.synchronize()


def _two_phase_warm(eng, shared):
    """Serve ``shared`` once on ``eng`` (one token), so its blocks are in
    the prefix cache before any item arrives."""
    req = eng.add_request(shared, 1)
    eng.run()
    if req.failed:
        raise AssertionError(f"warming the shared prefix: {req.state}")


def _two_phase(make_engine, items, shared, fresh_decode):
    """The path a handed-off request takes, on engines with no router, one
    item at a time as the pools pass sends them: an engine with ``shared``
    cached serves each item to its first token, then an engine with the
    item's prompt cached (the same one) or, with ``fresh_decode``, a fresh
    one with only ``shared`` cached (a fallback recomputes there) resumes
    each item from its first token. Returns the streams."""
    import torch

    def one(eng, p, m, t, s, resume=None):
        req = eng.add_request(p, m, temperature=t, seed=s,
                              resume_tokens=resume)
        eng.run()
        return req

    eng = make_engine()
    _two_phase_warm(eng, shared)
    first = [one(eng, p, 1, t, s) for p, _m, t, s in items]
    if fresh_decode:
        del eng
        gc.collect()
        eng = make_engine()
        _two_phase_warm(eng, shared)
    reqs = [one(eng, p, m, t, s, list(f.tokens))
            for (p, m, t, s), f in zip(items, first)]
    for r, (p, m, _t, _s) in zip(reqs, items):
        if r.failed or len(r.tokens) != m:
            raise AssertionError(f"two-phase run: {r.state} "
                                 f"{len(r.tokens)}/{m}")
    out = [list(r.tokens) for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stream_diff(tag, got, want):
    """The items whose stream differs from the target, logged with the
    first token where each parts; returns their count."""
    bad = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            bad += 1
            at = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                      min(len(g), len(w)))
            log(f"{tag}: item {i} parts from the direct run at token {at} "
                f"of {len(w)} (got {len(g)} tokens)")
    return bad


class _TimedReplicaMixin:
    """Times an in-process replica's KV export and import, and the first
    token of every resumed stream it runs (the decode leg of a handoff or a
    migration), for the cluster phase's report."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.times = {"export": [], "import": [], "leg_ttft": []}

    def export_kv(self, tokens):
        t0 = time.perf_counter()
        out = super().export_kv(tokens)
        self.times["export"].append(
            ((time.perf_counter() - t0) * 1e3,
             len(out["pages"]) if out else 0,
             int(out.get("nbytes", 0)) if out else 0))
        return out

    def import_kv(self, payload):
        t0 = time.perf_counter()
        n = super().import_kv(payload)
        self.times["import"].append(((time.perf_counter() - t0) * 1e3,
                                         n))
        return n

    def launch(self, stream):
        if stream.spec.resume_tokens:
            t0 = time.perf_counter()
            inner, seen = stream.on_chunk, []

            def first(s, toks):
                if not seen:
                    seen.append(1)
                    self.times["leg_ttft"].append(
                        (time.perf_counter() - t0) * 1e3)
                inner(s, toks)

            stream.on_chunk = first
        return super().launch(stream)


def _route_items(router, items, threads, on_progress=None):
    """Serve ``items`` [(prompt, new, temperature, seed)] through
    ``router`` from ``threads`` client threads (each submits its next item
    when its last one ends). Returns the tickets in item order and each
    ticket's chunk arrival times (host clock)."""
    import threading

    tickets, arrivals = [None] * len(items), [[] for _ in items]
    lock = threading.Lock()

    def job(i):
        p, m, t, s = items[i]

        def on_chunk(chunk, i=i):
            if chunk:
                arrivals[i].append(time.perf_counter())
                if on_progress is not None:
                    on_progress(len(chunk))

        tk = router.submit(p, m, temperature=t, seed=s, on_chunk=on_chunk)
        with lock:
            tickets[i] = tk
        tk.result(timeout=900)
        if tk.failure_reason is not None or len(tk.tokens) != m:
            raise AssertionError(f"item {i} ended {tk.failure_reason} with "
                                 f"{len(tk.tokens)}/{m} tokens")
        return tk

    _run_clients([lambda i=i: job(i) for i in range(len(items))], threads)
    return tickets, arrivals


def _failover_pass(tag, model, geo, items, want, ident, hard=True):
    """Two in-process replicas sharing ``model`` behind a ``Router``; once
    16 tokens reached the clients, replica 0 is poisoned. Checks: every
    stream equals ``want`` (``hard``: else the equal count is logged), no
    request failure, a migration, the supervised restart back ready, and
    device memory after it within one pool of the memory before the kill.
    Returns the victim's restart seconds."""
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.serving import InProcReplica, Router, ServingFrontend

    def factory():
        eng = Engine(model, **geo)
        _warm_graphs(eng)
        return ServingFrontend(eng)

    reps = [InProcReplica(factory, name=f"{tag[:1]}{i}", index=i)
            for i in range(2)]
    for r in reps:
        r.start()
    # the router's hedge and stall budgets from a warm replica's TTFT
    plen = min(512, model.config.max_position // 2)
    probe = reps[1].frontend.submit(
        np.random.default_rng(1).integers(0, model.config.vocab_size,
                                          (plen,)), 1)
    probe.result(timeout=300)
    if probe.failure_reason is not None:
        raise AssertionError(f"{tag}: the TTFT probe ended "
                             f"{probe.failure_reason}")
    ttft = probe.ttft_s
    # under the phase's load a first token waits behind running chains
    # (about ten times the idle TTFT): the hedge is for a first token far
    # slower than that, and a stall past the restart's seconds
    hedge_ms, stall_s = 50 * ttft * 1e3, max(30.0, 100 * ttft)
    log(f"{tag}: a warm replica's TTFT at {plen} tokens {ttft * 1e3:.1f} ms: "
        f"hedge_ms {hedge_ms:.0f}, stall_s {stall_s:.1f}")
    router = Router(reps, heartbeat_s=0.1, stall_s=stall_s,
                    hedge_ms=hedge_ms, restart_backoff_s=0.05).start()
    e = model.config
    pool_bytes = (2 * e.num_layers * geo["num_pages"] * geo["page_size"]
                  * e.num_kv_heads * e.head_dim
                  * torch.finfo(model.dtype).bits // 8)
    fails0 = _metric("paddle_tpu_request_failures_total")
    mig0 = _metric("paddle_tpu_router_migrations_total")
    kill = {}
    delivered = [0]
    lock = threading.Lock()

    def progress(n):
        with lock:
            delivered[0] += n
            go = delivered[0] >= 16 and "t" not in kill
            if go:
                kill["t"] = None  # claimed
        if go:
            torch.cuda.synchronize()
            kill["mem"] = torch.cuda.memory_allocated()
            kill["t"] = time.perf_counter()
            reps[0].kill()

    try:
        tickets, arrivals = _route_items(router, items, 4, progress)
        if kill.get("t") is None:
            raise AssertionError(f"{tag}: the streams ended before the kill")
        t_kill = kill["t"]
        ok = time.perf_counter()
        while time.perf_counter() - ok < 300:
            if reps[0].alive() and reps[0].restarts >= 1 \
                    and reps[0].ready().get("ready"):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"{tag}: the restart never came back ready")
        restart_s = time.perf_counter() - t_kill
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        got = [list(t.tokens) for t in tickets]
        migrated = [i for i, t in enumerate(tickets) if t.migrations]
        fails = _metric("paddle_tpu_request_failures_total") - fails0
        migs = _metric("paddle_tpu_router_migrations_total") - mig0
        stalls = [(next((a for a in arrivals[i] if a > t_kill), t_kill)
                   - t_kill) * 1e3 for i in migrated]
        ttfts = sorted(t.ttft_s * 1e3 for i, t in enumerate(tickets)
                       if i not in migrated)
        bad = _stream_diff(tag, got, want)
        log(f"{tag}: {len(items)} streams from 4 clients, replica 0 poisoned "
            f"after 16 delivered tokens ({delivered[0]} in all); "
            f"{len(migrated)} streams migrated ({int(migs)} migrations), "
            f"their stall kill -> next token "
            + ", ".join(f"{s:.1f}" for s in stalls)
            + f" ms; TTFT of the {len(ttfts)} not migrated: median "
            f"{statistics.median(ttfts):.1f}, max {max(ttfts):.1f} ms; the "
            f"restart back ready {restart_s:.2f} s after the kill; "
            f"{len(items) - bad} of {len(items)} streams equal the direct "
            f"run; {int(fails)} request failures; device memory before the "
            f"kill {kill['mem'] / 2**30:.2f} GiB, after the restart "
            f"{mem_after / 2**30:.2f} GiB (a pool {pool_bytes / 2**30:.2f} "
            f"GiB) [{ident}]")
        if fails or not migs or not migrated:
            raise AssertionError(f"{tag}: failures {fails}, migrations "
                                 f"{migs}")
        if abs(mem_after - kill["mem"]) > pool_bytes:
            raise AssertionError(f"{tag}: device memory moved more than a "
                                 "pool across the restart")
        if hard and bad:
            raise AssertionError(f"{tag}: {bad} streams differ from the "
                                 "direct run")
        for r in reps:
            _no_caught_fault(r.frontend.engine, tag)
        return restart_s
    finally:
        router.shutdown()
        del reps, router
        gc.collect()
        torch.cuda.empty_cache()


def _pools_pass(tag, model, geo, items, want, ident, fault_plan=None,
                hard=True, shared=None, threads=None):
    """A prefill replica and a decode replica (``pools``) behind a Router,
    sharing ``model``; ``shared``, a prefix each replica serves once
    before the load (so every item's admission splices it, whatever
    arrives with it); ``threads`` clients (default one an item). Checks:
    every stream equals ``want`` (``hard``; else the equal count is
    logged), no request failure; without a fault plan a handoff, with
    ``kv-handoff-corrupt`` a fallback. Returns the timings."""
    import torch

    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.serving import InProcReplica, Router, ServingFrontend

    class Timed(_TimedReplicaMixin, InProcReplica):
        pass

    def factory():
        eng = Engine(model, **geo)
        _warm_graphs(eng)
        if shared is not None:
            _two_phase_warm(eng, shared)
        return ServingFrontend(eng)

    reps = [Timed(factory, name=f"{tag[:1]}p{i}", index=i) for i in range(2)]
    router = Router(reps, heartbeat_s=0.1, stall_s=60.0,
                    pools={"prefill": 1, "decode": 1},
                    fault_plan=fault_plan).start()
    c0 = {k: _metric(f"paddle_tpu_{k}_total") for k in (
        "cluster_handoffs", "cluster_handoff_bytes", "cluster_fallbacks",
        "request_failures")}
    try:
        _wait_for(lambda: router.cluster._page_size is not None, 120,
                  f"{tag}: the router's first sweep")
        tickets, _ = _route_items(router, items, threads or len(items))
        d = {k: _metric(f"paddle_tpu_{k}_total") - v for k, v in c0.items()}
        got = [list(t.tokens) for t in tickets]
        bad = _stream_diff(tag, got, want)
        exp = [x for r in reps for x in r.times["export"]]
        imp = [x for r in reps for x in r.times["import"]]
        legs = [x for r in reps for x in r.times["leg_ttft"]]
        log(f"{tag}: {len(items)} streams, handoffs "
            f"{int(d['cluster_handoffs'])}, fallbacks "
            f"{int(d['cluster_fallbacks'])}, "
            f"{d['cluster_handoff_bytes'] / 2**20:.1f} MiB shipped; exports "
            "(ms, pages, MiB) "
            + ", ".join(f"({a:.1f}, {b}, {c / 2**20:.0f})" for a, b, c in exp)
            + "; adoptions (ms, pages) "
            + ", ".join(f"({a:.1f}, {b})" for a, b in imp)
            + "; decode-leg TTFT ms "
            + ", ".join(f"{x:.1f}" for x in legs)
            + f"; {len(items) - bad} of {len(items)} streams equal the "
            f"unpooled run; {int(d['request_failures'])} request failures "
            f"[{ident}]")
        if d["request_failures"]:
            raise AssertionError(f"{tag}: request failures")
        if fault_plan is None and d["cluster_handoffs"] < 1:
            raise AssertionError(f"{tag}: no handoff")
        if fault_plan is not None and d["cluster_fallbacks"] < 1:
            raise AssertionError(f"{tag}: no fallback")
        if hard and bad:
            raise AssertionError(f"{tag}: {bad} streams differ from the "
                                 "unpooled run")
        for r in reps:
            _no_caught_fault(r.frontend.engine, tag)
        return exp, imp, legs
    finally:
        router.shutdown()
        del reps, router
        gc.collect()
        torch.cuda.empty_cache()


def _subprocess_pass(tag, ident, root, model_args, vocab, new=256,
                     kill_after=16, hard=True):
    """Two ``serve_llama_paged_torch.py --api-port 0`` workers
    (``model_args``, prefix cache off) behind a Router; the one hosting a
    stream gets a real SIGKILL mid-stream. Checks: zero failures, a
    migration, the restarted worker ready, and (``hard``; else the equal
    count is logged) both streams equal the unkilled worker's own stream
    of the same prompt. The workers are stopped before returning."""
    import threading
    import urllib.request

    import numpy as np

    from paddle_tpu_torch.serving import Router, SubprocessReplica

    argv = [sys.executable, "-u",
            str(root / "examples" / "serve_llama_paged_torch.py"),
            *model_args, "--api-port", "0", "--prefix-cache", "off",
            "--fault-inject", "slow-step:every=1,delay_ms=200"]
    reps = [SubprocessReplica(argv, name=f"w{i}", index=i, cwd=str(root),
                              startup_timeout_s=600) for i in range(2)]
    t0 = time.perf_counter()
    errs = []

    def start(r):
        try:
            r.start()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ths = [threading.Thread(target=start, args=(r,)) for r in reps]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=700)
    router = None
    try:
        if errs or not all(r.alive() for r in reps):
            raise AssertionError(f"{tag}: a worker did not start {errs}")
        start_s = time.perf_counter() - t0
        prompt = [int(t) for t in
                  np.random.default_rng(12).integers(0, vocab, (64,))]
        req = urllib.request.Request(
            f"http://{reps[1].host}:{reps[1].port}/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": new}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            ref = json.loads(r.read())["choices"][0]["token_ids"]
        if len(ref) < 32:  # an eos may end it before ``new``
            raise AssertionError(f"{tag}: the unkilled stream is short")
        fails0 = _metric("paddle_tpu_request_failures_total")
        router = Router(reps, heartbeat_s=0.1, stall_s=120.0,
                        restart_dead=True, restart_backoff_s=0.1).start()
        ta = router.submit(prompt, new)
        tb = router.submit(prompt, new)
        _wait_for(lambda: min(len(ta.tokens), len(tb.tokens)) >= kill_after,
                  600, f"{tag}: {kill_after} tokens on both streams")
        live = [t for t in (ta, tb) if not t.done]
        if not live:
            raise AssertionError(f"{tag}: the streams ended before the kill")
        hit = live[0]
        victim = next(r for r in reps if r.name == hit.replica)
        at_kill = len(hit.tokens)
        t_kill = time.perf_counter()
        victim.kill()  # a real SIGKILL
        out_a, out_b = ta.result(timeout=900), tb.result(timeout=900)
        t_done = time.perf_counter()
        _wait_for(lambda: victim.alive() and victim.restarts >= 1
                  and victim.ready().get("ready"), 900,
                  f"{tag}: the restarted worker ready")
        restart_s = time.perf_counter() - t_kill
        fails = _metric("paddle_tpu_request_failures_total") - fails0
        bad = _stream_diff(tag, [out_a, out_b], [ref, ref])
        log(f"{tag}: two workers ({' '.join(model_args)}) up in "
            f"{start_s:.1f} s; SIGKILL of {victim.name} with {at_kill} tokens "
            f"streamed; both streams done {t_done - t_kill:.2f} s after the "
            f"kill (migrations {ta.migrations} + {tb.migrations}); "
            f"{2 - bad} of 2 equal the unkilled worker's stream; "
            f"{int(fails)} request failures; the restarted worker ready "
            f"{restart_s:.1f} s after the kill [{ident}]")
        if fails or ta.failure_reason or tb.failure_reason \
                or hit.migrations < 1:
            raise AssertionError(f"{tag}: the SIGKILL failover failed")
        if hard and bad:
            raise AssertionError(f"{tag}: {bad} streams differ from the "
                                 "unkilled worker's")
    finally:
        if router is not None:
            router.shutdown()
        else:
            for r in reps:
                r.stop()
        for r in reps:
            if r.alive():
                r.kill()


CLUSTER_LAYERS = 8


def phase_cluster(ident):
    """Multi-replica serving (the module docstring, phase 9) at
    ``llama2_7b`` widths bf16, ``CLUSTER_LAYERS`` of its 32 layers
    in-process (the workers of (c) at full depth): failover with in-process replicas,
    prefill/decode pools with the KV handoff, subprocess workers killed
    for real; then the same at f32, where the streams must equal the
    direct runs. Returns the launches by kernel row.

    bf16 rounds one token's work apart on different paths (a re-prefill
    against the decode steps that first made the tokens, the suffix
    kernel #3 against the flash prefill #2, one batch size against
    another), and a random-weight model's logit margins are small, so a
    migrated or handed-off bf16 stream may part from the direct run
    within a few tokens: at bf16 the equal streams are counted and
    logged, and every other check holds; at f32 (TF32 off) each stream
    must equal the direct run."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.llama import LlamaConfig

    # every kernel is built before any engine thread or worker starts
    build.build_all()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    total = {name: 0 for name in KERNELS}
    vanilla = ("paged_decode_attention", "flash_attention_fwd")
    spliced = vanilla + ("paged_verify_attention",)

    def counted(tag, run, needs, bf16):
        t_pass = time.perf_counter()
        out, got = _counted(run, needs, tc=tag if bf16 else None)
        log(f"{tag}: launches {got}; {time.perf_counter() - t_pass:.1f} s")
        if got.pop("flash_attention_bwd"):
            raise AssertionError(f"{tag}: serving launched the backward")
        for name, n in got.items():
            total[name] += n
        return out

    def direct(model, geo, items, tag):
        reqs, _ = _serve_items(Engine(model, **geo), items, tag)
        out = [list(r.tokens) for r in reqs]
        del reqs
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def cell(tag, model, geo, hard):
        """(a) failover and (b) pools, clean then corrupt, on ``model``."""
        vocab = model.config.vocab_size
        rng = np.random.default_rng(90)
        a_items = [(rng.integers(0, vocab, (int(rng.integers(16, 513)),)),
                    128, 0.8 if i % 4 == 3 else 0.0,
                    900 + i if i % 4 == 3 else None) for i in range(16)]
        rng = np.random.default_rng(91)
        shared = rng.integers(0, vocab, (512,))
        b_items = [(np.concatenate([shared, rng.integers(0, vocab, (32,))]),
                    64, 0.0, None) for _ in range(8)]
        want_a = direct(model, geo, a_items, f"{tag} direct (a)")
        if hard:
            want_b = want_c = direct(model, geo, b_items,
                                     f"{tag} direct (b)")
        else:
            # the path a handed-off stream takes, on engines with no
            # router: the equal count then says the handoff moved the
            # pages exactly
            def engine():
                return Engine(model, **geo)

            want_b = _two_phase(engine, b_items, shared, fresh_decode=False)
            want_c = _two_phase(engine, b_items, shared, fresh_decode=True)
        bf16 = model.dtype == torch.bfloat16
        counted(f"{tag} failover", lambda: _failover_pass(
            f"{tag} failover", model, geo, a_items, want_a, ident, hard),
            vanilla, bf16)
        # one client: each leg runs alone, as in the two-phase target, and
        # the corrupt bytes, drawn from the plan, land in item order
        counted(f"{tag} pools", lambda: _pools_pass(
            f"{tag} pools", model, geo, b_items, want_b, ident, hard=hard,
            shared=shared, threads=1), spliced, bf16)
        counted(f"{tag} pools corrupt", lambda: _pools_pass(
            f"{tag} pools corrupt", model, geo, b_items, want_c, ident,
            fault_plan="kv-handoff-corrupt:every=1", hard=hard,
            shared=shared, threads=1), spliced, bf16)

    geo = dict(max_slots=4, num_pages=512, page_size=16, chunk_size=16,
               max_chain=4, prefix_cache=True)
    t0 = time.perf_counter()
    # llama2_7b's widths at 8 of its 32 layers: the depth cut that makes
    # room for the bert and export phases in the run's time limit
    model = init_llama(LlamaConfig(num_layers=CLUSTER_LAYERS), seed=0,
                       device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"cluster: llama2_7b widths, {CLUSTER_LAYERS} layers, bf16 "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    cell("cluster bf16", model, geo, hard=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"cluster: device memory before the workers "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # (c) subprocess workers, each with its own process and memory
    _subprocess_pass("subprocess bf16", ident, root,
                     ("--model", "llama2_7b"), 32000, hard=False)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    try:
        model = init_llama(LlamaConfig(num_layers=2), seed=5, device="cuda",
                           dtype=torch.float32)
        cell("identity f32", model, dict(geo, num_pages=256), hard=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # f32 workers: the example's "small" LLaMA (4 layers, 256 wide)
    _subprocess_pass("identity f32 subprocess", ident, root,
                     ("--model", "small"), 128)
    return total

# ------------------------------------------------------------ draft
def tinyllama_1b(**kw):
    """LLaMA at the published widths of
    ``TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T`` (its
    ``config.json``): vocab 32000, hidden 2048, 22 layers, 32 heads over 4
    kv heads, intermediate 5632, max_position 2048, rms_eps 1e-5. Built
    here, not in the package."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    base = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                num_heads=32, num_kv_heads=4, intermediate_size=5632,
                max_position=2048, rms_eps=1e-5)
    base.update(kw)
    return LlamaConfig(**base)


def _draft_probe(eng):
    """Instrument ``eng``'s drafter (instance attributes over its methods):
    each propose step's drafts (a device copy) and the #1 launches it
    adds; each catch-up's rows, width and the #3 launches it adds. Times
    are CUDA events, read after the pass (no sync is added): ``run``
    brackets each propose step's ``step.run()`` alone (a graph replay, or
    the eager body with the host's launch gaps in it), ``catch_up`` each
    eager catch-up with its host packing and copies. Both are stream
    intervals, not device busy time. Returns the dict it fills."""
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    d = eng._spec.drafter
    note = {"drafts": [], "run": [], "catch_up": [], "p_dec": 0,
            "c_ver": 0, "c_dec": 0}
    run_propose, catch_up, get = d._run_propose, d._catch_up, d._graphs.get

    def timed(fn, *a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a)
        ev[1].record()
        return out, ev

    def get_w(key, make, keep=None):
        step = get(key, make, keep)
        if "run" not in vars(step):
            run = step.run

            def run_w(n=1):
                note["run"].append(timed(run, n)[1])

            step.run = run_w
        return step

    def propose_w(slots, nb, k):
        n0 = pa.paged_slab_decode_attention.launches
        out = run_propose(slots, nb, k)
        note["p_dec"] += pa.paged_slab_decode_attention.launches - n0
        note["drafts"].append(out.clone())
        return out

    def catch_up_w(rows):
        n0 = (pa.paged_verify_slab_attention.launches,
              pa.paged_slab_decode_attention.launches)
        _, ev = timed(catch_up, rows)
        note["c_ver"] += pa.paged_verify_slab_attention.launches - n0[0]
        note["c_dec"] += pa.paged_slab_decode_attention.launches - n0[1]
        note["catch_up"].append((ev, len(rows),
                                 max(r.size for _, r in rows)))

    d._run_propose, d._catch_up, d._graphs.get = propose_w, catch_up_w, get_w
    return note


def _greedy_tally(eng):
    """Count the drafts proposed and accepted on greedy rows apart
    (``eng._spec.note`` wrapped): a sampled row accepts a draft with the
    target's probability of it, well below 1 at random weights. Returns
    the dict it fills."""
    sp = eng._spec
    tally = {"proposed": 0, "accepted": 0}
    note = sp.note

    def note_w(req, proposed, accepted, landed):
        if req.temperature == 0.0:
            tally["proposed"] += proposed
            tally["accepted"] += min(accepted, proposed)
        return note(req, proposed, accepted, landed)

    sp.note = note_w
    return tally


def _draft_summary(note):
    """(the propose step's run ms median, catch-up ms median, the longest
    catch-up's ms and width) of a finished pass: stream intervals."""
    prop = [a.elapsed_time(b) for a, b in note["run"]]
    cat = [(a.elapsed_time(b), n, w) for (a, b), n, w in note["catch_up"]]
    longest = max(cat, key=lambda c: c[0]) if cat else (0.0, 0, 0)
    return (statistics.median(prop) if prop else 0.0,
            statistics.median(c[0] for c in cat) if cat else 0.0, longest)


def _drafter_ok(eng, tag):
    """``_no_caught_fault`` and the drafter's own steps: with its graphs on,
    every propose step must have been captured."""
    _no_caught_fault(eng, tag)
    graphs = eng._spec.drafter._graphs
    if graphs.enabled and any(st.graph is None
                              for st in graphs.steps.values()):
        raise AssertionError(f"{tag}: a propose step ran eagerly with "
                             "graphs on")


def _draft_items(vocab):
    """Pass (1)'s items, which the main phase draws first from seed 0:
    [(prompt, new tokens, temperature, seed)]."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (n,)), m, t, s)
            for n, m, t, s in ((16, 64, 0.0, None), (1024, 32, 0.0, None),
                               (300, 128, 0.8, 11), (64, 96, 0.0, None),
                               (700, 48, 0.8, 12), (128, 128, 0.0, None),
                               (33, 40, 0.0, None), (512, 64, 0.0, None),
                               (900, 32, 0.0, None), (200, 80, 0.0, None))]


DRAFT_LAYERS = 8


def phase_draft(ident):
    """Draft-model speculative decoding (``Engine(spec="draft",
    draft_model=)``): ``llama2_7b`` at full width, ``DRAFT_LAYERS`` of its
    32 layers, bf16, random
    weights from seed 0, on the pool and items of the main phase's pass
    (1), ``spec_k=4``, with (i) a LLaMA at TinyLlama-1.1B's widths (seed 1:
    acceptance near zero, what drafting costs) and (ii) the target as its
    own draft (every greedy draft should land). Each draft serves the
    items with the propose step on CUDA graphs and again eagerly (the
    drafter's graphs off): drafts and streams must be equal. Vanilla and
    n-gram passes on the same items give the tok/s to set beside; greedy
    streams are counted against vanilla. Then ``drafter-corruption:
    every=3``. Then f32, TF32 off, 2 layers at ``llama2_7b`` widths (drafts
    at TinyLlama widths, 2 layers, and the target itself): greedy draft
    streams, graph and eager, and the chaos pass must equal vanilla.
    Launches are counted per pass; the drafter's own #1 and #3 launches
    are logged apart."""
    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig

    t_phase = time.perf_counter()
    # llama2_7b's widths at 8 of its 32 layers: the depth cut that makes
    # room for the bert and export phases in the run's time limit
    cfg = LlamaConfig(num_layers=DRAFT_LAYERS)
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    tiny = init_llama(tinyllama_1b(), seed=1, device="cuda",
                      dtype=torch.bfloat16)
    log(f"draft: llama2_7b widths, {DRAFT_LAYERS} layers, bf16 and a "
        f"TinyLlama-width draft "
        f"({tinyllama_1b().num_params() / 1e9:.2f}B params, "
        f"{_model_gib(tiny):.2f} GiB) in {time.perf_counter() - t_phase:.1f}"
        f" s")
    total = {name: 0 for name in KERNELS}
    items = _draft_items(cfg.vocab_size)
    greedy = [i for i, it in enumerate(items) if it[2] == 0.0]

    def engine(m, **kw):
        return Engine(m, max_slots=8, num_pages=1024, page_size=16,
                      chunk_size=16, **kw)

    seen, streams = {}, {}

    def run_pass(tag, run, needs, tc=True):
        """``run()`` with the launch counters zeroed just before and read
        just after; ``tc``: a bf16 pass, whose flash and verify launches
        must all be tensor-core ones."""
        t_pass = time.perf_counter()
        got = _counted(run, needs, tc=tag if tc else None)[1]
        log(f"{tag}: launches {got}; {time.perf_counter() - t_pass:.1f} s")
        for name, n in got.items():
            if name in total:
                total[name] += n
        gc.collect()
        torch.cuda.empty_cache()

    def plain_pass(tag, **kw):
        def run():
            reqs, wall = _serve_items(_pin(engine(model, **kw)), items, tag)
            seen[tag] = _report(tag, reqs, wall, ident)
            streams[tag] = [list(r.tokens) for r in reqs]
        run_pass(tag, run, ("paged_decode_attention",) if not kw else
                 ("paged_verify_attention",))

    plain_pass("draft vanilla")
    plain_pass("draft ngram", spec="ngram", spec_k=4)
    same = sum(streams["draft ngram"][i] == streams["draft vanilla"][i]
               for i in greedy)
    log(f"draft ngram: greedy streams equal to vanilla: {same} of "
        f"{len(greedy)} (bf16: the verify kernel and the decode kernel "
        f"round apart) [{ident}]")
    notes = {}

    def draft_pass(tag, draft, graphs=True, plan=None):
        def run():
            eng = _pin(engine(model, spec="draft", draft_model=draft,
                              spec_k=4, fault_plan=plan))
            eng._spec.drafter._graphs.enabled = graphs
            note = notes[tag] = _draft_probe(eng)
            gt = _greedy_tally(eng)
            reqs = [eng.add_request(p, m, temperature=t, seed=s)
                    for p, m, t, s in items]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _check_done(reqs, items)
            sp = eng._spec
            if plan is None:
                _drafter_ok(eng, tag)
            elif eng._watchdog.last_fault is not None or not \
                    sp.drafter_faults:
                raise AssertionError(
                    f"{tag}: {sp.drafter_faults} drafter faults, step fault "
                    f"{eng._watchdog.last_fault!r}")
            seen[tag] = _report(tag, reqs, wall, ident)
            streams[tag] = [list(r.tokens) for r in reqs]
            st = sp.stats()
            prop_ms, cat_ms, longest = _draft_summary(note)
            match = sum(streams[tag][i] == streams["draft vanilla"][i]
                        for i in greedy)
            log(f"{tag}: {seen[tag][0]:.1f} tok/s (vanilla "
                f"{seen['draft vanilla'][0]:.1f}, ngram "
                f"{seen['draft ngram'][0]:.1f}); {st['verify_steps']} verify "
                f"steps, {sp.tokens_landed / max(1, st['verify_steps']):.2f} "
                f"tokens a verify step ({st['accept_per_step']:.2f} a "
                f"request-row); drafts {sp.drafts_accepted} accepted of "
                f"{sp.drafts_proposed} proposed, on greedy rows "
                f"{gt['accepted']} of {gt['proposed']}; propose step.run() "
                f"{prop_ms:.3f} ms a step ({'graph' if graphs else 'eager'},"
                f" {len(note['run'])} steps; stream interval), catch-up "
                f"median {cat_ms:.3f} ms over {len(note['catch_up'])} waves "
                f"(stream interval, host packing in it), the "
                f"longest {longest[0]:.3f} ms ({longest[1]} rows, width "
                f"{longest[2]}); the drafter launched #1 {note['p_dec']} "
                f"times (propose) and #3 {note['c_ver']} times (catch-up); "
                f"{sp.drafter_faults} drafter faults; greedy streams equal "
                f"to vanilla: {match} of {len(greedy)} [{ident}]")
            if not (note["p_dec"] and note["c_ver"]):
                raise AssertionError(f"{tag}: the drafter did not launch #1 "
                                     "and #3")
            # the drafts stay on the card: keep them, the probe is gone
            notes[tag] = [dr.cpu() for dr in note["drafts"]]
        run_pass(tag, run, ("paged_decode_attention",
                            "paged_verify_attention"))

    for name, draft in (("tinyllama", tiny), ("self", model)):
        tag = f"draft {name}"
        draft_pass(tag, draft)
        draft_pass(f"{tag} eager", draft, graphs=False)
        a, b = notes[tag], notes[f"{tag} eager"]
        if streams[tag] != streams[f"{tag} eager"] or len(a) != len(b) or \
                any(not torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{tag}: the propose on graphs and eagerly "
                                 "gave other drafts or streams")
        log(f"{tag}: the propose on graphs and eagerly: {len(a)} steps of "
            f"equal drafts, equal streams [{ident}]")
    draft_pass("draft tinyllama chaos", tiny,
               plan="drafter-corruption:every=3")
    match = sum(x == y for x, y in zip(streams["draft tinyllama chaos"],
                                       streams["draft tinyllama"]))
    log(f"draft tinyllama chaos: no request failed; {match} of "
        f"{len(items)} streams equal the clean run (bf16: a faulted step "
        f"verifies zero drafts, which rounds apart) [{ident}]")
    del model, tiny
    gc.collect()
    torch.cuda.empty_cache()

    # f32, TF32 off, 2 layers: identity with vanilla
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m32 = init_llama(LlamaConfig(num_layers=2), seed=0, device="cuda",
                         dtype=torch.float32)
        t32 = init_llama(tinyllama_1b(num_layers=2), seed=1, device="cuda",
                         dtype=torch.float32)
        r = np.random.default_rng(15)
        items32 = [(r.integers(0, cfg.vocab_size, (n,)), m, 0.0, None)
                   for n, m in ((20, 40), (300, 32), (64, 48), (700, 24),
                                (128, 40), (33, 32))]

        def serve32(tag, **kw):
            eng = Engine(m32, max_slots=4, num_pages=256, page_size=16,
                         chunk_size=16, **kw)
            if kw.get("spec") == "draft" and tag.endswith("eager"):
                eng._spec.drafter._graphs.enabled = False
            reqs = [eng.add_request(p, m, temperature=t, seed=s)
                    for p, m, t, s in items32]
            eng.run()
            torch.cuda.synchronize()
            _check_done(reqs, items32)
            if kw.get("fault_plan") is None:
                _no_caught_fault(eng, tag)
            elif not eng._spec.drafter_faults or \
                    eng._watchdog.last_fault is not None:
                raise AssertionError(f"{tag}: the plan faulted no proposal")
            out = [list(q.tokens) for q in reqs]
            if eng._spec is not None:
                sp = eng._spec
                log(f"{tag}: drafts {sp.drafts_accepted} accepted of "
                    f"{sp.drafts_proposed}, {sp.drafter_faults} drafter "
                    "faults")
                # the target drafting for itself at f32: every greedy
                # draft must land (a wrong drafter shows here, where
                # equal streams cannot see it)
                if kw.get("draft_model") is m32 and not \
                        sp.drafts_accepted == sp.drafts_proposed > 0:
                    raise AssertionError(
                        f"{tag}: {sp.drafts_accepted} of "
                        f"{sp.drafts_proposed} drafts accepted, not all")
            return out

        def f32_pass():
            want = serve32("draft f32 vanilla")
            for name, draft in (("tinyllama", t32), ("self", m32)):
                for tag in (f"draft f32 {name}", f"draft f32 {name} eager"):
                    if serve32(tag, spec="draft", draft_model=draft,
                               spec_k=4) != want:
                        raise AssertionError(f"{tag}: greedy streams differ "
                                             "from vanilla")
            if serve32("draft f32 chaos", spec="draft", draft_model=t32,
                       spec_k=4,
                       fault_plan="drafter-corruption:every=3") != want:
                raise AssertionError("draft f32 chaos: streams differ from "
                                     "the clean run")
            log("draft f32 (llama2_7b widths, 2 layers, TF32 off): greedy "
                "streams with each draft, graph and eager, and under "
                "drafter-corruption:every=3 equal vanilla")

        run_pass("draft f32", f32_pass, ("paged_decode_attention",
                                         "paged_verify_attention"), tc=False)
        del m32, t32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"draft: phase took {time.perf_counter() - t_phase:.1f} s")
    return total


@contextlib.contextmanager
def _plain_verify():
    """Every #3 call (the module global the cache code calls) on its plain
    version."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = pa._paged_verify
    pa._paged_verify = \
        lambda q, k, v, t, b, scale=None, scale_pages=None, **_: \
        pa.paged_verify_slab_attention_ref(q, k, v, t, b, scale, scale_pages)
    try:
        yield
    finally:
        pa._paged_verify = saved


@contextlib.contextmanager
def _plain_slab_decode():
    """Every #1 call on its plain version."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = pa._paged_slab_decode
    pa._paged_slab_decode = \
        lambda q, k, v, t, n, h=None, scale=None, scale_pages=None, **_: \
        pa.paged_slab_decode_attention_ref(q, k, v, t, n, scale=scale,
                                           scale_pages=scale_pages)
    try:
        yield
    finally:
        pa._paged_slab_decode = saved


@contextlib.contextmanager
def _verify_on_fma():
    """Every #3 launch on its FMA body (P kept in f32), where the rule
    would pick the tensor-core body (P rounded to bf16 before P.V)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = pa.verify_body
    pa.verify_body = lambda *a: "fma"
    try:
        yield
    finally:
        pa.verify_body = saved


def _kernel_split(torch, fn, top=6):
    """(stream interval ms, device busy ms, the ``top`` kernels by device
    ms) of one call of ``fn``: CUDA events behind a spin (``time_ms``),
    and torch.profiler's per-kernel device time (``_device_ms``)."""
    interval = time_ms(fn, warmup=2, reps=10)
    per = _device_ms(torch, fn, reps=10)
    busy = sum(per.values())
    kern = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return interval, busy, kern


def phase_draftcause(ident):
    """Opt-in (``--phases build,draftcause``): what holds the target's
    acceptance of its own drafts below all at bf16, and where a propose
    step's time goes. ``llama2_7b`` bf16, random weights from seed 0, as
    its own draft (``spec_k=4``) on the draft phase's items, with one
    piece at a time on another version: (a) as served; (b) the drafter's
    catch-up on #3's plain version; (c) the drafter's propose on #1's
    plain version (its steps eager); (d) every #3 launch, the target's
    verify steps and the drafter's catch-ups, on #3's FMA body, which
    keeps P in f32 where the tensor-core body rounds it to bf16 before
    P.V; (e) every attention kernel of both on its plain version (graphs
    off); (f) depth cut to 2 and to 8 layers, all else as (a). Logs drafts
    accepted of proposed and greedy streams equal to vanilla for each.
    Then the TinyLlama-width draft's propose step at 8 rows after a pass:
    its graph replay and its eager body on the same buffers, each with its
    stream interval, device busy ms and largest kernels under
    torch.profiler. Fails only if a request does not finish or a pass
    caught a fault."""
    import torch

    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig, llama2_7b

    t_phase = time.perf_counter()
    cfg = llama2_7b()
    items = _draft_items(cfg.vocab_size)
    greedy = [i for i, it in enumerate(items) if it[2] == 0.0]

    def serve(tag, model, draft=None, graphs=True, dgraphs=True,
              catch_up=None, propose=None):
        kw = dict(spec="draft", draft_model=draft, spec_k=4) if draft \
            else {}
        eng = _pin(Engine(model, max_slots=8, num_pages=1024, page_size=16,
                          chunk_size=16, **kw))
        eng.runner._graphs.enabled = graphs
        if draft is not None:
            gt = _greedy_tally(eng)
            d = eng._spec.drafter
            d._graphs.enabled = dgraphs
            for name, ctx in (("_catch_up", catch_up),
                              ("_run_propose", propose)):
                if ctx is not None:
                    def wrapped(*a, _fn=getattr(d, name), _ctx=ctx):
                        with _ctx():
                            return _fn(*a)
                    setattr(d, name, wrapped)
        reqs, wall = _serve_items(eng, items, tag)
        out = [list(r.tokens) for r in reqs]
        if draft is not None:
            sp = eng._spec
            st = sp.stats()
            log(f"draftcause {tag}: drafts {sp.drafts_accepted} accepted "
                f"of {sp.drafts_proposed} "
                f"({sp.drafts_accepted / max(1, sp.drafts_proposed):.1%}); "
                f"on greedy rows {gt['accepted']} of {gt['proposed']} "
                f"({gt['accepted'] / max(1, gt['proposed']):.1%}); "
                f"{sp.tokens_landed / max(1, st['verify_steps']):.2f} tokens "
                f"a verify step; {wall:.1f} s [{ident}]")
        return out, eng

    def settle():
        gc.collect()
        torch.cuda.empty_cache()

    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    vanilla = serve("vanilla", model)[0]

    def matches(tag, out):
        n = sum(out[i] == vanilla[i] for i in greedy)
        log(f"draftcause {tag}: greedy streams equal to vanilla: {n} of "
            f"{len(greedy)}")

    nothing = contextlib.nullcontext
    for tag, around, kw in (
            ("(a) as served", nothing, {}),
            ("(b) catch-up on plain #3", nothing,
             dict(catch_up=_plain_verify)),
            ("(c) propose on plain #1 (eager)", nothing,
             dict(dgraphs=False, propose=_plain_slab_decode)),
            ("(d) every #3 on the FMA body", _verify_on_fma, {}),
            ("(e) every attention kernel plain", _plain_kernels,
             dict(graphs=False, dgraphs=False))):
        def run(around=around, kw=kw, tag=tag):
            with around(), (_plain_verify if tag.startswith("(e)")
                            else nothing)():
                return serve(tag, model, model, **kw)[0]

        out, got = _counted(run)
        log(f"draftcause {tag}: launches "
            f"{ {n: c for n, c in got.items() if c} }")
        matches(tag, out)
        settle()
    del model
    settle()
    for layers in (2, 8):
        m = init_llama(LlamaConfig(num_layers=layers), seed=0, device="cuda",
                       dtype=torch.bfloat16)
        vanilla = serve(f"vanilla {layers} layers", m)[0]
        out = serve(f"(f) {layers} layers", m, m)[0]
        matches(f"(f) {layers} layers", out)
        del m
        settle()

    # the TinyLlama-width draft's propose step: graph replay and eager body
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    tiny = init_llama(tinyllama_1b(), seed=1, device="cuda",
                      dtype=torch.bfloat16)
    _, eng = serve("tinyllama", model, tiny)
    d = eng._spec.drafter
    key, g = max(((k, st) for (k, on), st in d._graphs.steps.items() if on),
                 key=lambda kv: kv[0][1])
    l0 = g.bufs.lengths.clone()
    d._graphs.enabled = False
    e = d._graphs.get(key, lambda: d._propose_step(*key[1:]))
    with torch.no_grad():
        for tag, step in (("graph replay", g), ("eager body", e)):
            step.load(tables=g.bufs.tables, last=g.bufs.last)

            def one(step=step):
                step.bufs.lengths.copy_(l0)
                step.run()

            interval, busy, kern = _kernel_split(torch, one)
            log(f"draftcause propose step {key[1:]} (rows, k), TinyLlama "
                f"widths, {tag}: stream interval {interval:.3f} ms, device "
                f"busy {busy:.3f} ms ({busy / interval:.1%}); largest: "
                + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in kern)
                + f" [{ident}]")
    del eng, d, g, e, model, tiny
    settle()
    log(f"draftcause: phase took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ fused
@contextlib.contextmanager
def _plain_kernels():
    """``_plain_decode`` and, besides #4, #14 and #15, the flash forward
    (#2, as ``F.flash_attention`` calls it) and the slab-paged decode (#1)
    replaced by their plain versions: a forward on the card held against
    itself on the plain versions."""
    from paddle_tpu_torch.nn.functional import attention as fattn
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    saved = (fattn.flash_attention_fwd, pa.paged_slab_decode_attention)
    fattn.flash_attention_fwd = \
        lambda q, k, v, causal=True, scale=None: fa.flash_attention_ref(
            q, k, v, causal=causal, scale=scale)
    pa.paged_slab_decode_attention = \
        lambda q, k, v, t, n, h=None, scale=None, scale_pages=None: \
        pa.paged_slab_decode_attention_ref(q, k, v, t, n, scale=scale,
                                           scale_pages=scale_pages)
    try:
        with _plain_decode():
            yield
    finally:
        fattn.flash_attention_fwd, pa.paged_slab_decode_attention = saved


FUSED_KINDS = {"5d": "decode_attention", "slab": "decode_attention_slab",
               "paged_kv": "paged_decode_attention_v1",
               "paged_state": "paged_decode_attention"}


def _fused_caches(layer, kind, batch, max_seq, dtype):
    """One cache per layer of ``layer`` (a ``FusedMultiTransformer``) of
    ``kind``: 5-D ``[2, B, H, S, D]``, the slab ``[2, B, S, H*D]``, a
    ``PagedKVCache`` or a ``PagedCacheState`` (16-row pages, each row its
    own pages, lengths 0)."""
    import torch

    from paddle_tpu_torch.ops.cuda.decode_attention import make_kv_slab
    from paddle_tpu_torch.ops.cuda.paged_attention import (PagedCacheState,
                                                           PagedKVCache)

    # a tensor-parallel layer's caches hold its rank's heads
    nh, hd, n = layer.local_heads, layer.head_dim, layer.num_layers
    dev = torch.device("cuda")
    if kind == "5d":
        return [torch.zeros((2, batch, nh, max_seq, hd), dtype=dtype,
                            device=dev) for _ in range(n)]
    if kind == "slab":
        return [make_kv_slab(batch, max_seq, nh, hd, dtype, dev)
                for _ in range(n)]
    pages = -(-max_seq // 16)
    if kind == "paged_kv":
        return [PagedKVCache(batch * pages + 1, 16, batch, nh, hd, pages,
                             dtype=dtype, device=dev) for _ in range(n)]
    tables = (torch.arange(batch * pages, dtype=torch.int32, device=dev)
              .view(batch, pages) + 1)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    shape = (batch * pages + 1, 16, nh * hd)
    return [PagedCacheState(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev),
                            None, tables, lengths, 16) for _ in range(n)]


def _fused_run(layer, kind, x, prompt):
    """The context phase on ``x[:, :prompt]`` then one decode step a
    column of the rest (teacher-forced: every kind sees the same inputs),
    on fresh caches of ``kind``. Returns (outputs [B, S, E] f32, decode ms
    a step by the host clock, each step ending in no sync)."""
    import torch

    batch, total, _ = x.shape
    caches = _fused_caches(layer, kind, batch, total, x.dtype)
    with torch.no_grad():
        out, caches = layer(x[:, :prompt], caches=caches)
        outs = [out.float()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt, total):
            out, caches = layer(x[:, t:t + 1], caches=caches, time_step=t)
            outs.append(out.float())
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (total - prompt)
    return torch.cat(outs, dim=1), ms


def _fused_width(tag, layer, batch, prompt, steps, ident, total):
    """Every cache kind of ``layer`` (bf16) on one teacher-forced input:
    decode ms a step and the launches a kernel per kind; each kind's
    outputs against the 5-D cache's within 5e-2 of the largest entry (the
    context rows are the same flash launches, the decode rows other
    kernels rounding apart in bf16)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((batch, prompt + steps, layer.embed_dim), generator=g,
                    device="cuda").to(torch.bfloat16)
    outs = {}
    for kind, kernel in FUSED_KINDS.items():
        def run(kind=kind):
            outs[kind] = _fused_run(layer, kind, x, prompt)
        t0 = time.perf_counter()
        _, got = _counted(run, ("flash_attention_fwd", kernel),
                          tc=f"fused {tag} {kind}")
        got = {k: v for k, v in got.items() if v}
        for name, n in got.items():
            if name in total:
                total[name] += n
        log(f"fused {tag} {kind}: B={batch}, prompt {prompt} + {steps} "
            f"decode steps: {outs[kind][1]:.3f} ms a decode step (host "
            f"clock), {batch / outs[kind][1] * 1e3:.1f} tokens/s; launches "
            f"{got}; {time.perf_counter() - t0:.1f} s [{ident}]")
    want = outs["5d"][0]
    top = float(want.abs().max())
    if not math.isfinite(top):
        raise AssertionError(f"fused {tag}: non-finite outputs")
    for kind in list(FUSED_KINDS)[1:]:
        err = float((outs[kind][0] - want).abs().max())
        if not err <= 5e-2 * top:
            raise AssertionError(f"fused {tag} {kind}: outputs off the 5-D "
                                 f"cache's by {err:.3g} (largest {top:.3g})")
        log(f"fused {tag} {kind}: outputs within {err:.3g} of the 5-D "
            f"cache's (largest entry {top:.3g}, limit 5e-2 of it)")
    del outs, x
    torch.cuda.empty_cache()


def phase_fused(ident):
    """``incubate.nn.FusedMultiTransformer`` (config 3's layer) at GPT-3
    6.7B widths (embed 4096, 32 heads, ffn 16384, 32 layers, bf16, 12.9 GB
    of weights from seed 0) and at GPT-2 small widths (768, 12, 3072, 12
    layers): B=8, a 128-token prompt (the context phase through #2) then
    128 teacher-forced decode steps over each cache kind (5-D: #14, the
    slab: #15, ``PagedKVCache``: #4, ``PagedCacheState``: #1); the four
    kinds' outputs must agree. Then f32, TF32 off, 2 layers at 6.7B
    widths: each kind against the same layer on the plain versions
    (within 1e-4 of the largest entry)."""
    import torch

    from paddle_tpu_torch.convert import init_fused_multi_transformer

    t_phase = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    for tag, (emb, nh, ff, layers) in (("6.7B", (4096, 32, 16384, 32)),
                                       ("gpt2 small", (768, 12, 3072, 12))):
        t0 = time.perf_counter()
        layer = init_fused_multi_transformer(emb, nh, ff, layers, seed=0,
                                             device="cuda",
                                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"fused {tag}: FusedMultiTransformer({emb}, {nh}, {ff}, "
            f"num_layers={layers}) bf16, {_model_gib(layer):.2f} GiB, in "
            f"{time.perf_counter() - t0:.1f} s")
        _fused_width(tag, layer, 8, 128, 128, ident, total)
        del layer
        gc.collect()
        torch.cuda.empty_cache()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        layer = init_fused_multi_transformer(4096, 32, 16384, 2, seed=0,
                                             device="cuda",
                                             dtype=torch.float32)
        g = torch.Generator(device="cuda").manual_seed(22)
        x = torch.randn((4, 48, 4096), generator=g, device="cuda")

        def f32_pass():
            for kind in FUSED_KINDS:
                got, _ = _fused_run(layer, kind, x, 32)
                with _plain_kernels():
                    want, _ = _fused_run(layer, kind, x, 32)
                _close_logits(f"fused f32 (6.7B widths, 2 layers) {kind} "
                              "against its plain run", got, want, 1e-4)

        _, got = _counted(f32_pass, ("flash_attention_fwd",)
                          + tuple(FUSED_KINDS.values()))
        log(f"fused f32: launches {({k: v for k, v in got.items() if v})}")
        del layer, x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fused: launches {({k: v for k, v in total.items() if v})}; phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return total


def check_ragged_dot(torch, dtype, H, FF, E, rows, timed, seed=41):
    """The grouped matmul's ``autograd.Function`` (``ragged_dot``: #13 for
    the forward and dX, one matmul per expert for dW) against
    ``grouped_matmul_ref`` under autograd, on lhs ``[rows, H]``, rhs ``[E,
    H, FF]`` and a cotangent from a seed, the group sizes those of a random
    routing with 1 row in 16 dropped (past the groups, as random routing's
    -1 pairs). y, dX and dW each within ``tol`` of the plain one's largest
    entry: bf16 2e-2, f32 1e-4 (sums in another order; bf16 rounds the
    output, and dX, once more). ``timed`` (bf16): #13's forward and dX
    (on the transposed weights) beside ``torch._grouped_mm`` on the same
    groups, the plain version and the bound; the transpose and dW's
    per-expert matmuls apart. Returns the record."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn((rows, H), generator=g, device="cuda").to(dtype)
    rhs = (torch.randn((E, H, FF), generator=g, device="cuda")
           / H ** 0.5).to(dtype)
    cot = torch.randn((rows, FF), generator=g, device="cuda").to(dtype)
    expert = torch.randint(0, E, (rows,), generator=g, device="cuda")
    dropped = torch.rand((rows,), generator=g, device="cuda") < 1 / 16
    expert = torch.where(dropped, E, expert)
    gs = torch.bincount(expert, minlength=E + 1)[:E].to(torch.int32)
    grads = {}
    for tag, fn in (("kernel", gm.ragged_dot),
                    ("plain", gm.grouped_matmul_ref)):
        a = lhs.clone().requires_grad_(True)
        b = rhs.clone().requires_grad_(True)
        y = fn(a, b, gs)
        y.backward(cot)
        grads[tag] = (y.detach(), a.grad, b.grad)
        del a, b, y
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    rec = {"body": gm.grouped_body(dtype, rows, H, FF, E),
           "dx_body": gm.grouped_body(dtype, rows, FF, H, E),
           "live_rows": int(gs.sum())}
    for name, got, want in zip(("y", "dx", "dw"), grads["kernel"],
                               grads["plain"]):
        err = _rel_max(torch, got, want)
        rec[f"err_{name}"] = err
        if not err <= tol:
            raise AssertionError(f"ragged_dot {dtype} H={H} F={FF}: {name} "
                                 f"off by {err:.3g} of the plain's largest "
                                 f"entry (limit {tol})")
    y = grads["kernel"][0]
    if bool(y[rec["live_rows"]:].any()):
        raise AssertionError("ragged_dot: rows past the groups are not "
                             "exactly zero")
    del grads, y
    if timed:
        wt = rhs.transpose(1, 2).contiguous()
        el = lhs.element_size()
        live = rec["live_rows"]
        for tag, a, b in (("fwd", lhs, rhs), ("dx", cot, wt)):
            k, n = b.shape[1], b.shape[2]
            nbytes = (live * k + E * k * n + rows * n) * el + E * 4
            b_ops = 2 * live * k * n / BF16_FLOPS_PER_S * 1e3
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            lib_name, lib = _grouped_library(torch, a, b, gs)
            rec.update({
                f"{tag}_ms": time_ms(lambda a=a, b=b: gm.grouped_matmul(
                    a, b, gs)),
                f"{tag}_bound_ms": max(b_ops, b_bytes),
                f"{tag}_bound_by": ("operations" if b_ops > b_bytes
                                    else "bytes"),
                f"{tag}_library_ms": time_ms(lib), "library": lib_name,
                f"{tag}_plain_ms": time_ms(
                    lambda a=a, b=b: gm.grouped_matmul_ref(a, b, gs),
                    warmup=1, reps=3)})
            del lib
        rec["transpose_ms"] = time_ms(
            lambda: rhs.transpose(1, 2).contiguous())
        rec["dw_ms"] = time_ms(lambda: gm._segment_weight_grad(
            lhs, cot, gs, E))
        del wt
    del lhs, rhs, cot
    torch.cuda.empty_cache()
    return rec


MOE_TRAIN = dict(blocks=2, batch=4, seq=1024, lr=5e-4, ragged_steps=4,
                 steps=3)


def phase_moe_train(ident):
    """MoE training at one GPU through ``incubate.distributed.models.moe``
    at Mixtral-8x7B's expert widths (see the module docstring). Returns
    the launches by kernel row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.ops.cuda import grouped_matmul as gm

    t_phase = time.perf_counter()
    cfg = mixtral_8x7b()
    H, FF, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    c = MOE_TRAIN
    tokens = c["batch"] * c["seq"]
    # (1) ragged_dot against its plain version at these widths (bf16) and
    # at a quarter of them (f32)
    for dtype, h, ff, timed in ((torch.bfloat16, H, FF, True),
                                (torch.float32, H // 4, FF // 4, False)):
        r = check_ragged_dot(torch, dtype, h, ff, E, 2 * tokens, timed)
        log(f"moe_train: ragged_dot {str(dtype)[6:]} [{2 * tokens}, {h}] x "
            f"[{E}, {h}, {ff}], {r['live_rows']} live rows, forward on the "
            f"{r['body']} body, dX on the {r['dx_body']} body: y, dX, dW "
            f"within {r['err_y']:.3g}, {r['err_dx']:.3g}, {r['err_dw']:.3g}"
            f" of the plain's largest entry [{ident}]")
        if timed:
            log(f"moe_train: #13 at the training shapes: forward "
                f"{r['fwd_ms']:.4f} ms (bound {r['fwd_bound_ms']:.4f}, "
                f"{r['fwd_bound_by']}; {r['library']} "
                f"{r['fwd_library_ms']:.4f}; plain {r['fwd_plain_ms']:.3f})"
                f", dX {r['dx_ms']:.4f} ms (bound {r['dx_bound_ms']:.4f}, "
                f"{r['dx_bound_by']}; {r['library']} "
                f"{r['dx_library_ms']:.4f}; plain {r['dx_plain_ms']:.3f}); "
                f"the weights' transpose {r['transpose_ms']:.4f} ms, dW's "
                f"per-expert matmuls {r['dw_ms']:.4f} ms [{ident}]")

    # (2) the model: blocks of LayerNorm -> MoELayer -> residual
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = nn.LayerNorm(H, device="cuda")
            self.moe = moe.MoELayer(
                H, [moe.ExpertFFN(H, FF, "silu", device="cuda")
                    for _ in range(E)],
                gate=moe.GShardGate(H, E, device="cuda"))

        def forward(self, x):
            return x + self.moe(self.norm(x))

    t0 = time.perf_counter()
    prandom.seed(18)
    ref32 = nn.LayerList([Block() for _ in range(c["blocks"])]).train()
    blocks = copy.deepcopy(ref32)
    for name, p in blocks.named_parameters():
        p.is_expert = ".experts." in name
    amp.decorate(blocks, level="O2")
    init = {n: p.detach().clone() for n, p in blocks.named_parameters()}
    n_params = sum(p.numel() for p in init.values())
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((c["batch"], c["seq"], H), generator=g,
                    device="cuda").to(torch.bfloat16)
    target = torch.randn(x.shape, generator=g, device="cuda")
    torch.cuda.synchronize()
    log(f"moe_train: {c['blocks']} blocks of LayerNorm({H}) -> MoELayer("
        f"{E} x ExpertFFN({H}, {FF}, silu), GShardGate top-2, random "
        f"routing) -> residual; {n_params / 1e9:.3f} B parameters, bf16 "
        f"(amp O2; an f32 copy for step 1), built in "
        f"{time.perf_counter() - t0:.1f} s; batch {c['batch']} x "
        f"{c['seq']} tokens [{ident}]")
    routed = []

    def capture(mod, inp, out):
        routed.append((out[0].detach(), out[1]))

    hooks = [b.moe.gate.register_forward_hook(capture) for b in blocks]

    def use(model, path):
        for i, b in enumerate(model):
            b.moe.use_ragged = path != "dense"
            b.moe.dropless = path == "dropless"
            b.moe.gate.generator = torch.Generator(
                device="cuda").manual_seed(100 + i)
        for p in model.parameters():
            p.grad = None
        routed.clear()

    def restart(path):
        use(blocks, path)
        with torch.no_grad():
            for n, p in blocks.named_parameters():
                p.copy_(init[n])

    def loss_fn(model=blocks):
        y = x.to(next(model.parameters()).dtype)
        for b in model:
            y = b(y)
        aux = torch.stack([b.moe.gate.get_loss().float() for b in model])
        return torch.mean((y.float() - target) ** 2) + 0.01 * aux.sum(), aux

    def train(path, steps):
        restart(path)
        opt = optimizer.AdamW(
            learning_rate=c["lr"], parameters=list(blocks.named_parameters()),
            weight_decay=0.01,
            grad_clip=moe.ClipGradForMOEByGlobalNorm(1.0))
        losses, auxes, dev, host = [], [], [], []
        for i in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            loss, aux = loss_fn()
            loss.backward()
            opt.step()
            opt.clear_grad()
            e1.record()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
            dev.append(e0.elapsed_time(e1))
            losses.append(float(loss.detach()))
            auxes.append(aux.tolist())
        if not (np.isfinite(losses).all() and np.isfinite(auxes).all()
                and losses[-1] < losses[0]):
            raise AssertionError(f"moe_train {path}: losses {losses}, aux "
                                 f"{auxes}: not finite and falling")
        del opt
        torch.cuda.empty_cache()
        return losses, auxes, dev, host

    res = {}

    def step1(model, path, routing=None):
        """Loss, aux, gradients, routing and #13's (launches, wgmma
        launches) in the forward and the backward of one step from the
        initial weights and routing draw. ``routing``: each block's expert
        indices to route by in place of its gate's (the gate's values,
        aux loss and gradients stay its own)."""
        use(model, path)
        forced = [] if routing is None else [
            b.moe.gate.register_forward_hook(
                lambda mod, inp, out, idx=idx: (out[0], idx))
            for b, idx in zip(model, routing)]
        l0 = gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches
        loss, aux = loss_fn(model)
        torch.cuda.synchronize()
        l1 = gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches
        loss.backward()
        torch.cuda.synchronize()
        l2 = gm.grouped_matmul.launches, gm.grouped_matmul.wgmma_launches
        for h in forced:
            h.remove()
        return dict(loss=float(loss.detach()), aux=aux.tolist(),
                    grads={n: p.grad.detach().clone()
                           for n, p in model.named_parameters()},
                    routed=list(routed), fwd=(l1[0] - l0[0], l1[1] - l0[1]),
                    bwd=(l2[0] - l1[0], l2[1] - l1[1]))

    def distance(a, b):
        """(loss off, relative, each gradient's relative norm off) of step
        ``a`` from step ``b``."""
        norms = {}
        for n, gb in b["grads"].items():
            ga, gb = a["grads"][n].float(), gb.float()
            norms[n] = (torch.linalg.vector_norm(ga - gb)
                        / torch.linalg.vector_norm(gb).clamp(min=1e-30)
                        ).item()
        return abs(a["loss"] - b["loss"]) / abs(b["loss"]), norms

    def summary(norms):
        worst = max(norms, key=norms.get)
        return (f"worst {norms[worst]:.3g} ({worst}), median "
                f"{statistics.median(norms.values()):.3g}")

    def compare(rg, dn, rg32, dn32):
        """Step 1 of the ragged path against the dense one, bf16 and f32,
        from the same weights and routing."""
        # the grouped matmul runs twice a block in the ragged forward and
        # twice in its backward (dX), each on the body grouped_body names
        # (wgmma at these shapes); the dense path never runs it
        want = (2 * c["blocks"], c["blocks"] * sum(
            gm.grouped_body(torch.bfloat16, 2 * tokens, k, n, E) == "wgmma"
            for k, n in ((H, FF), (FF, H))))
        if rg["fwd"] != want or rg["bwd"] != want:
            raise AssertionError(
                f"moe_train: ragged step 1 launched the grouped matmul "
                f"(launches, wgmma) {rg['fwd']} in the forward and "
                f"{rg['bwd']} in the backward, expected {want} in each")
        if dn["fwd"] != (0, 0) or dn["bwd"] != (0, 0):
            raise AssertionError(f"moe_train: the dense path launched #13 "
                                 f"{dn['fwd']} / {dn['bwd']}")
        # random routing's dropped second choices: present, and excluded
        # by the ragged routing (weight 0, past the groups)
        drops, flips = [], 0
        cap = blocks[0].moe._capacity(tokens)
        for (val, idx), (_, idx_d) in zip(rg["routed"], dn["routed"]):
            drops.append(int((idx == -1).sum()))
            flips += int((idx != idx_d).any(-1).sum())
            _, e_s, w_s, gs = moe.ragged_routing(idx, val, E, cap)
            kept = int((idx >= 0).sum())
            if int(gs.sum()) != kept or bool((e_s[kept:] != -1).any()) \
                    or bool(w_s[kept:].any()):
                raise AssertionError("moe_train: the ragged routing did not "
                                     "put the -1 pairs past the groups at "
                                     "weight 0")
        if min(drops) <= 0:
            raise AssertionError(f"moe_train: random routing dropped "
                                 f"{drops} second choices")
        l16, n16 = distance(rg, dn)
        l32, n32 = distance(rg32, dn32)
        _, r_off = distance(rg, rg32)
        _, d_off = distance(dn, dn32)
        log(f"moe_train: step 1 from the same weights and routing (the "
            f"dense runs and the f32 runs route by the bf16 ragged run's "
            f"indices; the dense run's own gates differed in {flips} token "
            f"rows, near ties after block 1's bf16 roundings); random "
            f"routing dropped {drops} second choices (a block, of "
            f"{tokens}); #13 (launches, wgmma) forward {rg['fwd']}, "
            f"backward {rg['bwd']}; aux {rg['aux']} [{ident}]")
        log(f"moe_train: step 1 f32, ragged vs dense: loss "
            f"{rg32['loss']:.7f} vs {dn32['loss']:.7f} (relative {l32:.3g},"
            f" limit 1e-5); gradients' relative norm {summary(n32)} (limit "
            f"1e-4) [{ident}]")
        log(f"moe_train: step 1 bf16, ragged vs dense: loss "
            f"{rg['loss']:.6f} vs {dn['loss']:.6f} (relative {l16:.3g}, "
            f"limit 1e-3); gradients' relative norm {summary(n16)} (limit "
            f"6e-2); each from the f32 step: ragged {summary(r_off)}, dense "
            f"{summary(d_off)} [{ident}]")
        if not (l32 <= 1e-5 and max(n32.values()) <= 1e-4):
            raise AssertionError("moe_train: ragged and dense f32 step 1 "
                                 "differ")
        if not (l16 <= 1e-3 and max(n16.values()) <= 6e-2):
            raise AssertionError("moe_train: ragged and dense bf16 step 1 "
                                 "differ beyond the bf16 limits")

    def run():
        nonlocal ref32
        rg = step1(blocks, "ragged")
        routing = [idx for _, idx in rg["routed"]]
        dn = step1(blocks, "dense", routing)
        rg32 = step1(ref32, "ragged", routing)
        dn32 = step1(ref32, "dense", routing)
        compare(rg, dn, rg32, dn32)
        del rg, dn, rg32, dn32
        ref32 = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res["train"] = {p: train(p, c["ragged_steps"] if p == "ragged"
                                 else c["steps"])
                        for p in ("ragged", "dense", "dropless")}
        res["peak"] = torch.cuda.max_memory_allocated() / 2**30

    _, got = _counted(run, needs=("grouped_matmul",))
    for h in hooks:
        h.remove()
    for path, (losses, auxes, dev, host) in res["train"].items():
        ms = statistics.mean(dev[1:])
        log(f"moe_train {path}: {len(losses)} AdamW steps (lr {c['lr']}, "
            f"ClipGradForMOEByGlobalNorm(1.0), experts is_expert): losses "
            f"{[round(v, 5) for v in losses]}, aux {auxes[-1]}; "
            f"{ms:.1f} ms a step on the device (CUDA events, steps 2-"
            f"{len(dev)}: {[round(v, 1) for v in dev[1:]]}), host "
            f"{1e3 * statistics.mean(host[1:]):.1f} ms; "
            f"{tokens / ms * 1e3:.0f} tokens/s [{ident}]")
    log(f"moe_train: peak memory {res['peak']:.2f} GiB over the three "
        f"paths' training; grouped matmul launches {got['grouped_matmul']} "
        f"[{ident}]")
    # #13's share of one ragged step's device time
    restart("ragged")
    opt = optimizer.AdamW(learning_rate=c["lr"],
                          parameters=list(blocks.named_parameters()))

    def one_step():
        loss, _ = loss_fn()
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()

    one_step()  # the optimizer's state is made outside the window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_step()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    gmm = sum(e.self_device_time_total for e in events
              if "grouped_" in e.key) / 1e3
    if not busy:
        log("moe_train: the profiler recorded no device time; #13's share "
            "is not measured")
    else:
        log(f"moe_train: one ragged step under torch.profiler: device busy "
            f"{busy:.1f} ms, #13 {gmm:.1f} ms = {gmm / busy:.1%} [{ident}]")
        for e in sorted(events, key=lambda e: -e.self_device_time_total
                        )[:8]:
            log(f"  device {e.self_device_time_total / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")
    del opt, prof, events, blocks, init, x, target
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe_train: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"grouped_matmul": got["grouped_matmul"]}


def phase_loadgen(ident):
    """Opt-in: the four ported serving benches at ``gpt2_small()`` in bf16
    on the card (``on_gpu=True``), each returned dict on one line. They
    are measurements; only their correctness parts fail the phase: no
    request failure in any bench, the failover bench's migrated streams
    and every request completed, the cluster bench's completions."""
    import torch

    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.gpt import gpt2_small
    from paddle_tpu_torch.serving import loadgen

    build.build_all()  # before any front-end thread starts
    cfg = gpt2_small()
    for name in ("bench_slo_serving", "bench_trace_serving",
                 "bench_failover_serving", "bench_cluster_serving"):
        fails0 = _metric("paddle_tpu_request_failures_total")
        t0 = time.perf_counter()
        out = getattr(loadgen, name)(cfg, True)
        fails = _metric("paddle_tpu_request_failures_total") - fails0
        log(f"loadgen {name} ({time.perf_counter() - t0:.1f} s, "
            f"{int(fails)} request failures) [{ident}]: "
            + json.dumps(out, sort_keys=True))
        if fails:
            raise AssertionError(f"loadgen {name}: request failures")
        if name == "bench_failover_serving" and not (
                out["failover_zero_failures"]
                and out["failover_migrated_streams"] >= 1):
            raise AssertionError("loadgen: the failover bench lost streams")
        if name == "bench_cluster_serving" and not out[
                "cluster_zero_failures"]:
            raise AssertionError("loadgen: the cluster bench lost streams")
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ resnet
TF32_PEAK_FLOPS_PER_S = 495e12  # dense TF32 tensor-core peak
RESNET_CHILD = dict(images=128, batch=32, size=224, epochs=2, ckpt_freq=3,
                    kill_at=5, lr=0.05)


def _resnet_data(np, n, size, classes, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3, size, size), dtype=np.float32)
    Y = rng.integers(0, classes, (n,)).astype(np.int64)
    return X, Y


def _resnet_model(pt, seed, lr, metrics=True):
    """``resnet50(num_classes=1000)`` on the card with weights from
    ``seed``, prepared as ``examples/train_resnet_torch.py`` does."""
    from paddle_tpu_torch import metric, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet

    pt.seed(seed)
    net = resnet.resnet50(num_classes=1000)
    model = pt.Model(net)
    model.prepare(optimizer=optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=net.parameters()),
        loss=nn.CrossEntropyLoss(),
        metrics=metric.Accuracy() if metrics else None)
    return model


def _resnet_flops(torch, net, size):
    """Training FLOPs a 224x224 image: 3x the forward's 2*MACs of every
    convolution and the classifier (batch norms, ReLUs and pools left
    out), counted by hooks on one eval forward."""
    from paddle_tpu_torch import nn

    macs = []

    def hook(mod, inp, out):
        if isinstance(mod, nn.Conv2D):
            k = mod.weight.shape[1] * mod.weight.shape[2] * \
                mod.weight.shape[3]
            macs.append(out[0].numel() * k)
        else:
            macs.append(mod.weight.numel())

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (nn.Conv2D, nn.Linear))]
    try:
        net.eval()
        with torch.no_grad():
            net(torch.zeros((1, 3, size, size),
                            device=next(net.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return 3 * 2 * sum(macs)


def _state_digest(net):
    """sha256 over every parameter's and buffer's name and bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in net.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _resnet_child(spec):
    """One child of the resnet phase's checks 2 and 3: deterministic
    algorithms on (``CUBLAS_WORKSPACE_CONFIG`` came in the environment,
    before CUDA started), ``resnet50`` at 224x224, batch 32, 128 images,
    2 epochs of 4 steps, a checkpoint every 3 steps. Writes its results
    as JSON to ``spec["out"]``."""
    import os
    import signal
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (CheckpointManager,
                                              TrainingPreempted)
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.inference.errors import IntegrityError
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.observability import metric_total
    from paddle_tpu_torch.testing.faultinject import FaultPlan

    if not torch.cuda.is_available():
        raise RuntimeError("resnet child: no CUDA device")
    torch.use_deterministic_algorithms(True)
    c = RESNET_CHILD
    X, Y = _resnet_data(np, c["images"], c["size"], 1000, 11)
    data = TensorDataset([X, Y])
    mode, root = spec["mode"], spec["root"]
    out = {"mode": mode}

    class Rec(Callback):
        def __init__(self, kill_at=None):
            self.losses, self.kill_at = [], kill_at

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            if len(self.losses) == self.kill_at:
                os.kill(os.getpid(), signal.SIGTERM)

    def fit(model, ckpt_dir, rec, **kw):
        return model.fit(data, batch_size=c["batch"], epochs=c["epochs"],
                         verbose=0, ckpt_dir=ckpt_dir,
                         ckpt_freq=c["ckpt_freq"], callbacks=[rec], **kw)

    def model(seed=0):
        return _resnet_model(pt, seed, c["lr"], metrics=False)

    if mode in ("clean", "resume"):
        m, rec = model(0 if mode == "clean" else 123), Rec()
        fit(m, root, rec, resume="auto" if mode == "resume" else None)
        out.update(losses=rec.losses, digest=_state_digest(m.network))
    elif mode == "kill":
        m, rec = model(0), Rec(kill_at=c["kill_at"])
        try:
            fit(m, root, rec)
            raise AssertionError("resnet kill child: SIGTERM did not stop "
                                 "fit")
        except TrainingPreempted as e:
            out.update(losses=rec.losses, step=e.step,
                       committed=ckpt.is_complete(e.checkpoint_path))
    elif mode == "faults":  # the training points
        # train-step-exception: two injected faults, retried
        m, rec = model(0), Rec()
        r0 = metric_total("paddle_tpu_train_step_retries_total")
        fit(m, os.path.join(root, "retry"), rec, max_step_retries=2,
            retry_backoff=0.001, fault_plan="train-step-exception:times=2")
        out["retry"] = dict(
            losses=rec.losses,
            retries=metric_total("paddle_tpu_train_step_retries_total") - r0)
        # train-nan-loss: rolled back, the batch skipped
        m, rec = model(0), Rec()
        r0 = metric_total("paddle_tpu_train_rollbacks_total")
        hist = fit(m, os.path.join(root, "nan"), rec,
                   fault_plan="train-nan-loss:at=5")
        out["nan"] = dict(
            steps=len(rec.losses),
            rollbacks=metric_total("paddle_tpu_train_rollbacks_total") - r0,
            finite=bool(np.isfinite(hist["loss"]).all() and all(
                torch.isfinite(t).all() for t in
                m.network.state_dict().values())))
    elif mode == "preempt":  # preempt-signal, then the checkpoint points
        # preempt-signal: drained and committed, then resumed
        m, rec = model(0), Rec()
        try:
            fit(m, os.path.join(root, "preempt"), rec,
                fault_plan=f"preempt-signal:at={c['kill_at']}")
            raise AssertionError("preempt-signal did not stop fit")
        except TrainingPreempted as e:
            step = e.step
        m2, rec2 = model(77), Rec()
        fit(m2, os.path.join(root, "preempt"), rec2, resume="auto")
        out["preempt"] = dict(step=step, losses=rec.losses + rec2.losses,
                              digest=_state_digest(m2.network))
        # the checkpoint points, on the model's own state
        state = {k: v for k, v in m2.network.state_dict().items()}
        mgr = CheckpointManager(os.path.join(root, "io"))
        mgr.save(1, state)
        bad = CheckpointManager(os.path.join(root, "io"),
                                fault_plan=FaultPlan("ckpt-io-error:at=2"))
        try:
            bad.save(2, state)
            raise AssertionError("ckpt-io-error did not fail the save")
        except OSError:
            pass
        kept = mgr.restore()[0]
        out["io"] = dict(steps=mgr.all_steps(), restored=kept)
        mgr = CheckpointManager(os.path.join(root, "flip"), keep_last_n=5)
        mgr.save(1, state)
        flip = CheckpointManager(os.path.join(root, "flip"), keep_last_n=5,
                                 fault_plan=FaultPlan("bit-flip-ckpt:times=1"))
        flip.save(2, state)
        try:
            ckpt.verify_contents(flip.step_path(2))
            refused = False
        except IntegrityError:
            refused = True
        step, back = flip.restore()
        out["flip"] = dict(steps=flip.all_steps(), refused=refused,
                           restored=step, equal=all(
                               torch.equal(back[k], v.cpu())
                               for k, v in state.items()))
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(root, "fast")).save(1, state)
        fast = time.perf_counter() - t0
        slow = CheckpointManager(os.path.join(root, "slow"),
                                 fault_plan=FaultPlan(
                                     "slow-ckpt-write:delay_ms=500,times=1"))
        t0 = time.perf_counter()
        slow.save(1, state)
        out["slow"] = dict(fast_s=fast, slow_s=time.perf_counter() - t0,
                           fired=slow.fault_plan.fired("slow-ckpt-write"),
                           steps=slow.all_steps())
    else:
        raise ValueError(f"unknown resnet child mode {mode!r}")
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


class _ResnetChildren:
    """Checks 2 and 3 of the resnet phase in child processes, on a thread
    of this process: clean, kill (a real SIGTERM) and the fault points
    (training ones in ``faults``, preempt-signal and the checkpoint ones in
    ``preempt``) start at once, the resume as soon as the kill child ends,
    under a temporary directory of ``root``. The children need no kernel
    of ``csrc/``, so a full run starts them beside the build
    (``main``) and waits for them before any phase measures on the card.
    ``result()`` returns each child's JSON, ``faults`` holding both fault
    children's, and the seconds they took."""

    def __init__(self, root):
        import tempfile
        import threading

        self._tmp = tempfile.TemporaryDirectory(prefix="resnet_", dir=root)
        self._env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        self._res, self._err, self.seconds = {}, None, None
        self._procs = {}
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="resnet-children")
        self._thread.start()

    def _start(self, mode, ckpt_dir):
        tmp = self._tmp.name
        spec = dict(mode=mode, root=os.path.join(tmp, ckpt_dir),
                    out=os.path.join(tmp, f"{mode}.json"))
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--resnet-child", json.dumps(spec)], env=self._env)

    def _collect(self, mode, proc):
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"resnet child {mode} timed out")
        if rc != 0:
            raise AssertionError(f"resnet child {mode} exited {rc}")
        with open(os.path.join(self._tmp.name, f"{mode}.json")) as f:
            self._res[mode] = json.load(f)

    def _run(self):
        procs = self._procs
        try:
            for m, d in (("clean", "a"), ("kill", "b"), ("faults", "c"),
                         ("preempt", "d")):
                procs[m] = self._start(m, d)
            self._collect("kill", procs.pop("kill"))
            procs["resume"] = self._start("resume", "b")
            for mode in list(procs):
                self._collect(mode, procs.pop(mode))
            self._res["faults"].update(self._res.pop("preempt"))
        except BaseException as e:  # noqa: BLE001 - raised by result()
            self._err = e
        finally:
            self.stop()
            self.seconds = time.perf_counter() - self._t0

    def stop(self):
        """Kill the children that still run."""
        for p in list(self._procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()

    def result(self):
        self._thread.join(timeout=1200)
        try:
            if self._thread.is_alive():
                self.stop()
                raise AssertionError("resnet children outlived 1200 s")
            if self._err is not None:
                raise self._err
            return self._res, self.seconds
        finally:
            self._tmp.cleanup()


def _resnet_root():
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return root


def phase_resnet(ident, children=None):
    """Config 1 through ``paddle_tpu_torch.Model.fit`` on the card. (1)
    ``resnet50(num_classes=1000)`` f32 at torch's default cuDNN settings
    (TF32 convolutions on, TF32 matmuls off, no benchmark search): 1024
    random 224x224 images and labels from a seed, batch 256, Momentum
    0.05/0.9, ``CrossEntropyLoss`` and ``Accuracy``, 2 epochs of 4 steps;
    finite losses and an ``evaluate`` accuracy; images/s, ms a step, each
    step's host and device ms (CUDA events) and the loader's share, peak
    memory, FLOPs a training image and the share of the peak. (2) In
    child processes with deterministic algorithms, ``resnet50`` at
    224x224, batch 32, 128 images: a clean run, a run stopped by a real
    SIGTERM at step 5 (committed, ``TrainingPreempted``) and its resume;
    the stitched losses and final state equal the clean run's bitwise.
    (3) Each training and checkpoint fault point fires once and recovers
    as the reference says. (2) and (3) run in ``children``, the
    ``_ResnetChildren`` that ``main`` started beside the build, or in
    children started here."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import Dataset

    t_phase = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        n, batch, size = 1024, 256, 224
        X, Y = _resnet_data(np, n, size, 1000, 0)

        class DS(Dataset):
            def __len__(self):
                return n

            def __getitem__(self, i):
                return X[i], Y[i]

        class Clock(Callback):
            def __init__(self):
                self.rows = []

            def on_train_batch_begin(self, step, logs=None):
                self.t0 = time.perf_counter()
                self.ev0 = torch.cuda.Event(enable_timing=True)
                self.ev0.record()

            def on_train_batch_end(self, step, logs=None):
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                ev1.synchronize()
                self.rows.append(dict(begin=self.t0,
                                      end=time.perf_counter(),
                                      dev=self.ev0.elapsed_time(ev1),
                                      loss=float(logs["loss"])))

        model = _resnet_model(pt, 0, 0.05)
        flops = _resnet_flops(torch, model.network, size)
        clock = Clock()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = model.fit(DS(), epochs=2, batch_size=batch, verbose=0,
                         callbacks=[clock])
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [r["loss"] for r in clock.rows]
        if len(losses) != 8 or not np.isfinite(losses).all():
            raise AssertionError(f"resnet: losses {losses}")
        ev = model.evaluate(DS(), batch_size=batch)
        acc = ev.get("eval_acc")
        if not (isinstance(acc, float) and 0.0 <= acc <= 1.0
                and math.isfinite(ev["eval_loss"])):
            raise AssertionError(f"resnet: evaluate gave {ev}")
        rows = clock.rows
        steps = [b["end"] - a["end"] for a, b in zip(rows, rows[1:])]
        loader = [b["begin"] - a["end"] for a, b in zip(rows, rows[1:])]
        dev = [r["dev"] for r in rows[1:]]
        step_ms = 1e3 * statistics.mean(steps)
        ips = batch / statistics.mean(steps)
        share = [lo / st for lo, st in zip(loader, steps)]
        idle = [1.0 - d / (1e3 * st) for d, st in zip(dev, steps)]
        log(f"resnet (1): resnet50 f32, 1000 classes, 224x224, batch "
            f"{batch}, {n} images, 2 epochs x 4 steps through Model.fit; "
            f"cuDNN TF32 convolutions on, TF32 matmuls off, benchmark off "
            f"(torch's defaults) [{ident}]")
        log(f"resnet (1): losses {[round(v, 4) for v in losses]}, epoch "
            f"means {[round(v, 4) for v in hist['loss']]}; evaluate "
            f"acc {acc:.4f} loss {ev['eval_loss']:.4f}; fit {fit_s:.1f} s "
            f"(first step {1e3 * (rows[0]['end'] - rows[0]['begin']):.1f} "
            f"ms host) [{ident}]")
        log(f"resnet (1): {ips:.1f} images/s, {step_ms:.2f} ms a step "
            f"(steps 2-8, host clock between step ends: "
            f"{[round(1e3 * v, 2) for v in steps]}); peak memory "
            f"{peak:.2f} GiB [{ident}]")
        log(f"resnet (1): a step's host ms (collate + pin + H2D + train) "
            f"vs device ms (CUDA events around train_batch): "
            f"{[round(1e3 * v, 2) for v in steps]} vs "
            f"{[round(v, 2) for v in dev]}; the loader's host ms "
            f"{[round(1e3 * v, 2) for v in loader]}, its share "
            f"{statistics.mean(share):.1%}, device idle "
            f"{statistics.mean(idle):.1%} of a step [{ident}]")
        tf = flops * ips / 1e12
        log(f"resnet (1): {flops / 1e9:.2f} GFLOPs a training image (3x "
            f"the forward's conv + fc MACs x2); {tf:.1f} TFLOP/s = "
            f"{flops * ips / TF32_PEAK_FLOPS_PER_S:.1%} of the 495 TF/s "
            f"TF32 peak ({flops * ips / F32_FLOPS_PER_S:.1%} of 67 TF/s "
            f"f32) [{ident}]")
        del model, X, Y
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = flags

    if children is None:
        children = _ResnetChildren(str(_resnet_root()))
    res, children_s = children.result()
    c = RESNET_CHILD
    clean, kill, resume = res["clean"], res["kill"], res["resume"]
    if kill["step"] != c["kill_at"] or not kill["committed"]:
        raise AssertionError(f"resnet (2): SIGTERM run {kill}")
    if kill["losses"] != clean["losses"][:c["kill_at"]]:
        raise AssertionError("resnet (2): the killed run's losses differ")
    stitched = kill["losses"] + resume["losses"]
    if stitched != clean["losses"] or resume["digest"] != clean["digest"]:
        raise AssertionError(
            f"resnet (2): resume not bitwise: {stitched} vs "
            f"{clean['losses']}; digests {resume['digest'][:16]} vs "
            f"{clean['digest'][:16]}")
    log(f"resnet (2): deterministic children, resnet50 {c['size']}x"
        f"{c['size']} batch "
        f"{c['batch']}, {c['images']} images, 2 x 4 steps: clean, SIGTERM "
        f"at step {c['kill_at']} (committed, TrainingPreempted), resumed: "
        f"stitched losses and state sha256 {clean['digest'][:16]} bitwise "
        f"equal the clean run's [{ident}]")
    f = res["faults"]
    checks = {
        "train-step-exception": f["retry"]["losses"] == clean["losses"]
        and f["retry"]["retries"] == 2,
        "train-nan-loss": f["nan"]["rollbacks"] == 1
        and f["nan"]["steps"] == 7 and f["nan"]["finite"],
        "preempt-signal": f["preempt"]["step"] == c["kill_at"]
        and f["preempt"]["losses"] == clean["losses"]
        and f["preempt"]["digest"] == clean["digest"],
        "ckpt-io-error": f["io"]["steps"] == [1]
        and f["io"]["restored"] == 1,
        "bit-flip-ckpt": f["flip"]["steps"] == [1, 2]
        and f["flip"]["refused"] and f["flip"]["restored"] == 1
        and f["flip"]["equal"],
        "slow-ckpt-write": f["slow"]["fired"] == 1
        and f["slow"]["steps"] == [1]
        and f["slow"]["slow_s"] >= 0.5,
    }
    log(f"resnet (3): {json.dumps(f['slow'])}; rollbacks "
        f"{int(f['nan']['rollbacks'])}, retries "
        f"{int(f['retry']['retries'])}; "
        + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                    for k, v in checks.items()) + f" [{ident}]")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resnet (3): {failed} did not recover: {f}")
    log(f"resnet: children {children_s:.1f} s (started beside the build "
        f"in a full run); phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{ident}]")

# ------------------------------------------------------------ bert, export
def _example(name):
    """The module ``examples/<name>.py`` of this checkout."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bert_flops(cfg, batch, seq):
    """Training FLOPs of one BERT MLM step: 6 x the tokens x the matrix
    parameters the forward multiplies by (the encoder's GEMMs, the
    pooler, the MLM transform and the tied decoder), plus attention's 12
    x layers x B x S^2 x hidden (QK^T and PV, forward and backward)."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    mats = cfg.num_hidden_layers * (4 * h * h + 2 * h * f) + 2 * h * h \
        + v * h
    tokens = batch * seq
    return 6 * mats * tokens + 12 * cfg.num_hidden_layers * batch \
        * seq * seq * h


def _rel_max(torch, got, want):
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def phase_bert(ident, steps=5):
    """Config 2 at one GPU through the twin's step
    (``examples/train_bert_torch.py`` ``mlm_step``: ``jit.functional_call``
    + ``torch.autograd.grad`` + ``AdamW.apply_gradients_tree``) at
    BERT-base (12 layers, 768 wide, 12 heads of 64, vocab 30522), f32
    with TF32 off, seq 512, dropout 0, weights from a seed. (a) ``steps``
    steps at batch 32 on one repeated batch: finite losses that fall, the
    flash forward and backward launched (f32 at D 64: the FMA bodies);
    sequences/s, tokens/s, host and device ms a step, peak memory, and
    one step under torch.profiler: device busy ms and the flash kernels'
    share. (b) The gradients of one step with every encoder layer under
    ``fleet.recompute`` against the plain step's (each tensor within 1e-5
    of its largest entry), the flash forward launched twice as often, and
    a lower peak memory. Returns the launches by kernel row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import init_bert
    from paddle_tpu_torch.jit import functional_call, param_arrays
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion

    ex = _example("train_bert_torch")
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, batch, seq = ex.configs(True)
        model = init_bert(cfg, seed=0, device="cuda")
        model.train()
        crit = BertPretrainingCriterion(cfg.vocab_size)
        opt = optimizer.AdamW(learning_rate=1e-4)
        params = param_arrays(model)
        state = opt.init_state_tree(params)
        ids, labels = ex.mlm_batch(np.random.default_rng(0),
                                   cfg.vocab_size, batch, seq, "cuda")
        total = {"flash_attention_fwd": 0, "flash_attention_bwd_fused": 0}

        def run():
            nonlocal params, state
            losses, host, dev = [], [], []
            for i in range(steps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                params, state, loss = ex.mlm_step(model, crit, opt, params,
                                                  state, ids, labels, i + 1)
                e1.record()
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
                dev.append(e0.elapsed_time(e1))
                losses.append(float(loss))
            return losses, host, dev

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (losses, host, dev), got = _counted(
            run, needs=("flash_attention_fwd", "flash_attention_bwd"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"bert (a): losses {losses} are not finite "
                                 "and falling")
        per = cfg.num_hidden_layers  # each flash kernel's launches a step
        if got["flash_attention_fwd"] != steps * per \
                or got["flash_attention_bwd"] != steps * per:
            raise AssertionError(f"bert (a): launches {got}, expected "
                                 f"{per} of each a step")
        total["flash_attention_fwd"] += got["flash_attention_fwd"]
        total["flash_attention_bwd_fused"] += got["flash_attention_bwd"]
        step_s = statistics.mean(host[1:])
        dev_ms = statistics.mean(dev[1:])
        flops = _bert_flops(cfg, batch, seq)
        log(f"bert (a): BERT-base f32 (TF32 off), batch {batch} x seq {seq}, "
            f"{steps} functional steps (functional_call + autograd.grad + "
            f"AdamW(1e-4).apply_gradients_tree) on one repeated batch; "
            f"losses {[round(v, 4) for v in losses]} [{ident}]")
        log(f"bert (a): {batch / step_s:.2f} sequences/s, "
            f"{batch * seq / step_s:.0f} tokens/s; a step {1e3 * step_s:.1f} "
            f"ms host (steps 2-{steps}: "
            f"{[round(1e3 * v, 1) for v in host[1:]]}), "
            f"{dev_ms:.1f} ms device (CUDA events: "
            f"{[round(v, 1) for v in dev[1:]]}); peak memory {peak:.2f} "
            f"GiB; {flops / 1e12:.2f} TFLOP a step = "
            f"{flops / step_s / 1e12:.1f} TFLOP/s, "
            f"{flops / step_s / F32_FLOPS_PER_S:.1%} of the 67 TF/s f32 "
            f"peak; flash launches {got['flash_attention_fwd']} forward, "
            f"{got['flash_attention_bwd']} backward (the #5 row: "
            f"Sq = Sk = {seq} <= 1024, no lse cotangent) [{ident}]")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ex.mlm_step(model, crit, opt, params, state, ids, labels,
                        steps + 1)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        fl = {e.key: e.self_device_time_total / 1e3 for e in events
              if "flash_" in e.key}
        if not busy:
            log("bert (a): the profiler recorded no device time; the "
                "flash share is not measured")
        else:
            log(f"bert (a): one step under torch.profiler: device busy "
                f"{busy:.1f} ms; the flash kernels {sum(fl.values()):.1f} "
                f"ms = {sum(fl.values()) / busy:.1%} of it [{ident}]")
            for e in sorted(events, key=lambda e: -e.self_device_time_total
                            )[:10]:
                log(f"  device {e.self_device_time_total / 1e3:9.3f} ms  "
                    f"x{e.count:<5d} {e.key[:90]}")
        del prof, events

        # (b) recompute: the same step's gradients, every encoder layer
        # under fleet.recompute
        def grads():
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            loss = crit(functional_call(model, leaves, ids), labels)
            return torch.autograd.grad(loss, list(leaves.values()),
                                       allow_unused=True)

        res = {}
        out_plain, got_plain = _counted(lambda: res.update(
            plain=_peak_pass(torch, lambda: res.update(g0=grads()))))
        ex.use_recompute(model)
        try:
            out_rc, got_rc = _counted(lambda: res.update(
                rc=_peak_pass(torch, lambda: res.update(g1=grads()))))
        finally:
            for layer in model.bert.encoder.layers:
                del layer.forward  # back to the class's forward
        worst = max(_rel_max(torch, a, b) for a, b in
                    zip(res["g1"], res["g0"]) if b is not None)
        exact = all(torch.equal(a, b) for a, b in zip(res["g1"], res["g0"])
                    if b is not None)
        if worst > 1e-5:
            raise AssertionError(f"bert (b): recompute gradients off by "
                                 f"{worst:.3g} of the largest entry")
        if got_rc["flash_attention_fwd"] != 2 * \
                got_plain["flash_attention_fwd"]:
            raise AssertionError(f"bert (b): recompute ran the flash "
                                 f"forward {got_rc['flash_attention_fwd']} "
                                 f"times, the plain step "
                                 f"{got_plain['flash_attention_fwd']}")
        if res["rc"] >= res["plain"]:
            raise AssertionError(f"bert (b): recompute peak {res['rc']} >= "
                                 f"plain {res['plain']}")
        for g in (got_plain, got_rc):
            total["flash_attention_fwd"] += g["flash_attention_fwd"]
            total["flash_attention_bwd_fused"] += g["flash_attention_bwd"]
        log(f"bert (b): one step's gradients, every encoder layer under "
            f"fleet.recompute vs plain: worst {worst:.3g} of the largest "
            f"entry (bitwise equal: {exact}; limit 1e-5); flash forward "
            f"launches {got_rc['flash_attention_fwd']} vs "
            f"{got_plain['flash_attention_fwd']} (the re-run in the "
            f"backward); peak memory {res['rc'] / 2**30:.2f} GiB vs "
            f"{res['plain'] / 2**30:.2f} GiB [{ident}]")
        del model, params, state, res
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"bert: phase took {time.perf_counter() - t_phase:.1f} s")
    return total


def _host_ms(torch, fn, reps=5):
    """Median host milliseconds of ``fn()`` to a device sync, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _export_case(tag, model, spec, inputs, ident, tmp):
    """``model`` (eval, on the card) eagerly, through ``to_static``,
    through ``jit.save`` -> ``jit.load`` and through
    ``create_predictor(Config(prefix)).run`` on each of ``inputs`` (one
    tensor each; ``to_static`` on the first): every output within 1e-4 of
    the eager one's largest entry, #2 launched in the compiled, the loaded
    and the predictor's calls; ms a call of each. Returns #2's
    launches."""
    import torch

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.jit import load, save, to_static

    n = 0

    def counted(what, fn):
        nonlocal n
        out, got = _counted(fn, needs=("flash_attention_fwd",))
        n += got["flash_attention_fwd"]
        return out, got["flash_attention_fwd"]

    def close(what, got, want):
        err = _rel_max(torch, torch.as_tensor(got).to(want.device), want)
        if not err <= 1e-4:
            raise AssertionError(f"export {tag}: {what} off by {err:.3g} of "
                                 f"the largest entry (limit 1e-4)")
        return err

    with torch.no_grad():
        eager = [model(x) for x in inputs]
        static = to_static(model)
        t0 = time.perf_counter()
        static(inputs[0])
        compile_s = time.perf_counter() - t0
        out, k_static = counted("to_static", lambda: static(inputs[0]))
        e_static = close("to_static", out, eager[0])
        prefix = str(tmp / tag.replace(" ", "_"))
        t0 = time.perf_counter()
        save(model, prefix, input_spec=[spec])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load(prefix)
        pred = create_predictor(Config(prefix + ".pt2"))
        load_s = time.perf_counter() - t0
        rows = []
        for x, want in zip(inputs, eager):
            out, k_loaded = counted("jit.load", lambda: loaded(x))
            e_loaded = close(f"jit.load {tuple(x.shape)}", out, want)
            (res,), k_pred = counted("Predictor",
                                     lambda: pred.run([x.cpu().numpy()]))
            e_pred = close(f"Predictor {tuple(x.shape)}", res, want)
            rows.append(f"{tuple(x.shape)}: jit.load err {e_loaded:.3g} "
                        f"(#2 x{k_loaded}), Predictor err {e_pred:.3g} (#2 "
                        f"x{k_pred})")
        x = inputs[0]
        ms = dict(eager=_host_ms(torch, lambda: model(x)),
                  static=_host_ms(torch, lambda: static(x)),
                  loaded=_host_ms(torch, lambda: loaded(x)),
                  predictor=_host_ms(torch, lambda: pred.run(
                      [x.cpu().numpy()])))
    log(f"export {tag}: to_static compiled in {compile_s:.1f} s, err "
        f"{e_static:.3g} (#2 x{k_static}); jit.save {save_s:.1f} s "
        f"(InputSpec {spec.shape} {spec.dtype}), jit.load + "
        f"create_predictor {load_s:.1f} s; " + "; ".join(rows)
        + f" (limit 1e-4 of the largest entry) [{ident}]")
    log(f"export {tag}: ms a call at {tuple(x.shape)} (host clock to a "
        f"sync, median of 5): eager {ms['eager']:.3f}, to_static "
        f"{ms['static']:.3f}, jit.load {ms['loaded']:.3f}, Predictor.run "
        f"{ms['predictor']:.3f} (with its host copies in and out) "
        f"[{ident}]")
    return n


def phase_export(ident):
    """Config 5: #2 at the twin example's ``TinyTransformer`` shape against
    its plain version, timed; the ``TinyTransformer`` (d 64, 4 heads of
    16: #2 at D = 16, f32) at ``[2, 16]``, then ``BertForMaskedLM`` at
    BERT-base width, 2 of its 12 layers, f32 with TF32 off, seq 512,
    through ``to_static``
    at batch 8 and a ``jit.save`` with ``InputSpec([None, 512])`` run at
    batches 8 and 4 by ``jit.load`` and the Predictor (``_export_case``).
    Returns the launches by kernel row."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.convert import init_bert
    from paddle_tpu_torch.jit import InputSpec

    ex = _example("to_static_export_torch")
    bert_ex = _example("train_bert_torch")
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 0
    try:
        # #2 at the TinyTransformer's own shape (4 heads of 16, f32,
        # non-causal: the FMA body at D = 16), timed
        r16 = check_flash(torch, torch.float32, 2, 16, 4, 16, atol=1e-4,
                          rtol=1e-4, timed=True, causal=False)
        log(_row(f"export flash_attention_fwd f32 B=2 S=16 H=4 D=16 "
                 f"non-causal (config 5's TinyTransformer; atol 1e-4 rtol "
                 f"1e-4; library sdpa) [{ident}]", r16))
        with tempfile.TemporaryDirectory() as d:
            tmp = Path(d)
            tiny = ex.init_tiny(ex.TinyTransformer(device="cuda")).eval()
            ids = torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (2, 16)).astype(np.int32)).cuda()
            n += _export_case("TinyTransformer", tiny,
                              InputSpec([2, 16], "int32"), [ids], ident,
                              tmp)
            cfg, _, seq = bert_ex.configs(True)
            # 2 of BERT-base's 12 layers: the compile's time grows with
            # the layers, and the run's time limit holds every phase
            cfg = dataclasses.replace(cfg, num_hidden_layers=2)
            bert = init_bert(cfg, seed=0, device="cuda").eval()
            rng = np.random.default_rng(1)
            xs = [torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, seq)).astype(np.int32)).cuda()
                for b in (8, 4)]
            n += _export_case("BertForMaskedLM", bert,
                              InputSpec([None, seq], "int32"), xs, ident,
                              tmp)
            del tiny, bert
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"export: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": n}


if __name__ == "__main__":
    sys.exit(main())
