"""Time the PyTorch port's ``Engine.adopt_kv_pages`` on one device: a KV
handoff payload of whole pages (random rows in the pool's layout, on the
host, with their blake2b digests, as ``CacheCoordinator.export_handoff``
gives them) adopted into a fresh prefix cache at ``llama2_7b`` widths.

    python tools/adopt_bench_torch.py [--root TREE] [--layers 8]
        [--pages 32] [--reps 5] [--dtype bf16] [--device cuda]

``--root`` imports ``paddle_tpu_torch`` from another checkout, so one
script times two trees (run them in one call, A B B A). Each adoption uses
tokens of its own, so every one restores all its pages; the first is a
warm-up. An adoption's ms is host clock from the call to a device
synchronize after it. Prints one JSON line: the package it imported, the
card's name and power limit (``nvidia-smi``), the payload's bytes and
every adoption's ms. No kernel of the port runs: the adoption is the
digests, the upload and the pool's ``index_copy_``.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--pages", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.convert import init_llama
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.inference.kv_tier import page_bytes
    from paddle_tpu_torch.models.llama import llama2_7b

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for a dry run)")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = llama2_7b()
    cfg.num_layers = args.layers
    ps = 16
    model = init_llama(cfg, seed=0, device=dev, dtype=dtype)
    eng = Engine(model, max_slots=2, page_size=ps, prefix_cache=True,
                 num_pages=args.pages * (args.reps + 1) + 8, device=dev)
    flat = eng._cache.pages_flat()
    gen = torch.Generator().manual_seed(0)
    rows = [[torch.randn(tuple(b.shape[1:]), generator=gen).to(b.dtype)
             for b in flat] for _ in range(args.pages)]
    digests = []
    for page in rows:
        d = hashlib.blake2b(digest_size=16)
        for a in page:
            d.update(page_bytes(a))
        digests.append(d.hexdigest())
    nbytes = sum(a.numel() * a.element_size() for page in rows for a in page)
    rng = np.random.default_rng(0)
    ms = []
    for _ in range(args.reps + 1):
        payload = {"page_size": ps, "digests": digests, "pages": rows,
                   "tokens": [int(t) for t in rng.integers(
                       0, cfg.vocab_size, args.pages * ps)]}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.adopt_kv_pages(payload)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if got != args.pages:
            raise SystemExit(f"adopted {got} of {args.pages} pages")
    pkg = os.path.dirname(paddle_tpu_torch.__file__)
    print(json.dumps({"package": pkg,
                      "card": _card() if dev.type == "cuda" else "cpu",
                      "layers": args.layers, "pages": args.pages,
                      "dtype": args.dtype, "bytes": int(nbytes),
                      "warmup_ms": ms[0], "ms": ms[1:],
                      "median_ms": float(np.median(ms[1:]))}))


if __name__ == "__main__":
    main()
