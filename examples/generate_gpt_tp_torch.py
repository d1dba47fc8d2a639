"""Config 3 on the PyTorch/CUDA port: GPT generation under ``fleet`` at
``mp`` ranks, the twin of ``generate_gpt_tp.py``, and beside it the fused
decoder stack (``incubate.nn.FusedMultiTransformer``) at ``nranks = mp``,
where config 3's sharding is real.

Each of ``mp`` rank processes (``torch.multiprocessing``, a
``torch.distributed`` world on localhost) runs ``fleet.init`` with
``mp_degree = mp``, builds GPT from seed 0, wraps it with
``fleet.distributed_model`` (GPT's parameters carry no ``dist_spec``, so
they stay replicated, broadcast from the group's first rank, as in the
reference) and generates greedily. Then the fused stack: each rank holds
``num_heads / mp`` heads of the packed QKV weight and ``FF / mp`` columns
of FFN1 (``convert.init_fused_multi_transformer(..., nranks=mp)``), one
all-reduce after the output projection and one after FFN2, over a 5-D
KV cache of its own heads; a context phase, then decode steps.

``--check`` (on by ``--tiny``): every rank's tokens equal rank 0's, rank
0's equal an mp=1 generate of the same model, and the fused stack's
outputs at f32 equal ``nranks = 1``'s within 1e-4 (GPT-2 small widths:
2e-3, twelve heads' partial sums added in another order).

    python examples/generate_gpt_tp_torch.py --tiny            # CPU, mp=2
    python examples/generate_gpt_tp_torch.py --mp 2 --backend gloo --check
    python examples/generate_gpt_tp_torch.py --mp 8           # 8 cards
"""
import argparse
import json
import os as _os
import socket
import sys as _sys
import time

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np


def _config(args):
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt2_small

    if args.tiny:
        return GPTConfig(hidden_size=64, num_layers=2, num_heads=4,
                         max_position=128, vocab_size=256), 16, 2
    return gpt2_small(), 128, 8


def run_rank(rank, args, world, init_method):
    """One rank: its world, then :func:`generate_in_world`; rank 0 prints a
    JSON line of what it measured and checked, and fails if a check
    failed."""
    from paddle_tpu_torch.distributed import (barrier, destroy_process_group,
                                              init_parallel_env)

    init_parallel_env(device=args.device, backend=args.backend,
                      init_method=init_method, rank=rank, world_size=world)
    try:
        report = generate_in_world(args, world)
        # rank 0 hosts the rendezvous store: no rank leaves before all are
        # done with it
        barrier()
        if rank == 0:
            print("generate_gpt_tp:", json.dumps(report), flush=True)
            if args.check and not (report["ranks_equal"]
                                   and report["equals_mp1"]
                                   and report["fused_ok"]):
                raise SystemExit("generate_gpt_tp: a check failed")
    finally:
        destroy_process_group()


def generate_in_world(args, world):
    """In a running world of ``world`` ranks: ``fleet.init`` at mp=world,
    ``distributed_model``, greedy ``generate``, then the fused stack.
    Returns this rank's report (the checks' results on rank 0)."""
    import torch

    from paddle_tpu_torch.convert import init_gpt
    from paddle_tpu_torch.distributed import all_gather_object, fleet

    rank = torch.distributed.get_rank()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": world}
    fleet.init(is_collective=True, strategy=strategy,
               device=args.device)
    cfg, prompt_len, batch = _config(args)
    dtype = torch.float32 if (args.tiny or args.check) \
        else torch.bfloat16
    model = init_gpt(cfg, seed=0, device=args.device, dtype=dtype)
    fleet.distributed_model(model)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int64)
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=args.new_tokens,
                         temperature=0.0)
    gen_s = time.perf_counter() - t0
    toks = out.cpu().numpy()
    report = {"mp": world, "batch": batch, "prompt": prompt_len,
              "new_tokens": args.new_tokens,
              "generate_s": round(gen_s, 4)}
    if args.check:
        every = all_gather_object([], toks.tolist())
        report["ranks_equal"] = all(t == every[0] for t in every)
        if rank == 0:
            single = init_gpt(cfg, seed=0, device=args.device,
                              dtype=dtype).generate(
                ids, max_new_tokens=args.new_tokens, temperature=0.0)
            report["equals_mp1"] = bool(
                np.array_equal(single.cpu().numpy(), toks))
    report.update(_fused(cfg, args, world, dtype))
    return report


def _fused(cfg, args, world, dtype):
    """The fused stack at GPT's widths (its layers, its FF = 4H) at
    nranks = mp: ms a decode step, and (``--check``) its outputs against
    nranks = 1's on rank 0."""
    import torch

    from paddle_tpu_torch.convert import init_fused_multi_transformer

    h, nh, layers = cfg.hidden_size, cfg.num_heads, cfg.num_layers
    ff, hd = 4 * h, h // nh
    b, s0, steps, smax = 2, 8, 4, 16
    dev = torch.device(args.device if args.device != "cuda"
                       else f"cuda:{torch.cuda.current_device()}")

    def run(nranks):
        fmt = init_fused_multi_transformer(h, nh, ff, layers, seed=1,
                                           device=dev, dtype=dtype,
                                           nranks=nranks)
        caches = [torch.zeros((2, b, nh // nranks, smax, hd), dtype=dtype,
                              device=dev) for _ in range(layers)]
        r = np.random.default_rng(2)
        x = torch.from_numpy(r.standard_normal((b, s0, h)).astype(
            np.float32)).to(dev, dtype)
        outs, times = [], []
        with torch.no_grad():
            y, caches = fmt(x, caches=caches)
            outs.append(y.float().cpu())
            tok = y[:, -1:]
            for t in range(s0, s0 + steps):
                t0 = time.perf_counter()
                tok, caches = fmt(tok, caches=caches, time_step=t)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
                outs.append(tok.float().cpu())
        return outs, times

    outs, times = run(world)
    rep = {"fused_step_ms": round(1e3 * float(np.median(times)), 4)}
    if args.check:
        from paddle_tpu_torch.distributed import get_rank

        if get_rank() == 0:
            ref, _ = run(1)
            err = max(float((a - r).abs().max()) for a, r in zip(outs, ref))
            tol = 1e-4 if args.tiny else 2e-3
            rep.update(fused_max_abs_err=err, fused_tol=tol,
                       fused_ok=err <= tol)
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer 64-wide GPT at mp=2 on the CPU, checked")
    ap.add_argument("--mp", type=int, default=None,
                    help="model-parallel ranks (default 2 with --tiny, "
                         "else 8)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (--tiny's)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default NCCL on the card, gloo on the CPU; ranks "
                         "that share one card need gloo")
    ap.add_argument("--new_tokens", type=int, default=16)
    ap.add_argument("--check", action="store_true",
                    help="f32, and hold the ranks, mp=1 and nranks=1 "
                         "against each other (on with --tiny)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.check = True
        args.device = args.device or "cpu"
    args.device = args.device or "cuda"
    return args


def main(argv=None):
    args = parse_args(argv)
    world = args.mp or (2 if args.tiny else 8)
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(run_rank, args=(args, world,
                                       f"tcp://127.0.0.1:{port}"),
                       nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
