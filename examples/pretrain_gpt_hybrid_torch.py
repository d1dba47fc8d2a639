"""Config 4 on the PyTorch/CUDA port: GPT hybrid pretraining, mp x pp x dp
(+ ZeRO on the sharding axis), the twin of ``pretrain_gpt_hybrid.py``.

Each rank process (``torch.multiprocessing``, a ``torch.distributed``
world on localhost) runs ``fleet.init`` with the reference's degrees,
builds only its stage of the ``PipelineLayer`` of ``build_layers`` (an
embedding, the transformer blocks on ``ColumnParallelLinear`` /
``RowParallelLinear``, the head), wraps it with
``fleet.distributed_model`` (a ``PipelineParallel``) and
``fleet.distributed_optimizer(AdamW(1e-4, ClipGradByGlobalNorm(1.0)))``,
and trains by ``train_batch`` on the global batch, which every rank draws
from the same seeded stream. Rank 0 prints each step's loss (the global
batch's mean, the same on every rank), tokens/s after the first step and
the ``profiler.mfu`` readout, which counts the whole model's parameters
(each rank holds its stage's mp shard: the counts are summed over ``mp``
and ``pp``). ``--ckpt DIR`` saves the parameters by every rank
(``save_state_dict(group=)``: the mp shards as blocks, each stage its
own names), one checkpoint that one process loads whole.

The block's attention reshapes the QKV output as the reference does,
``[b, s, 3, heads, head_dim]`` over the whole 3 x hidden columns; the
column-parallel QKV gives each rank a contiguous block of those columns,
so the block all-gathers them (a reduce-scatter in the backward, as the
reference's XLA program reshards them) and attends over its own
``heads / mp`` heads, whose output columns are the row-parallel
projection's input block. The loss takes the rank's vocabulary columns of
the (replicated) head's logits into ``ParallelCrossEntropy``.

Tiny mode (default): mp 2 x pp 2, which makes dp 2 at 8 ranks; hidden 64,
4 heads, 4 layers, vocab 128; global batch 8 x 32 in 2 microbatches.
``--real`` is the reference's shape: mp 8 x pp 4 x sharding 4, hidden
4096, 32 heads, 32 layers, vocab 50304, global batch 512 x 2048 in 16
microbatches, with recompute (128 cards).

    python examples/pretrain_gpt_hybrid_torch.py --device cpu
    python examples/pretrain_gpt_hybrid_torch.py --backend gloo  # one card
"""
import argparse
import os as _os
import socket
import sys as _sys
import time

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import numpy as np
import torch


def configs(real):
    """``(dims, (hidden, heads, layers, vocab), (batch, seq, micro))`` of
    the reference's two modes."""
    if real:
        return (dict(mp=8, pp=4, sharding=4), (4096, 32, 32, 50304),
                (512, 2048, 16))
    return dict(mp=2, pp=2, sharding=1), (64, 4, 4, 128), (8, 32, 2)


def build_layers(hidden, heads, n_layers, vocab):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.collective import fcollectives
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, LayerDesc, RowParallelLinear)
    from paddle_tpu_torch.nn import functional as F

    class Embed(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(vocab, hidden)

        def forward(self, x):
            return self.word(x)

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.qkv = ColumnParallelLinear(hidden, 3 * hidden,
                                            gather_output=False)
            self.proj = RowParallelLinear(hidden, hidden,
                                          input_is_parallel=True)
            self.ln2 = nn.LayerNorm(hidden)
            self.fc1 = ColumnParallelLinear(hidden, 4 * hidden,
                                            gather_output=False)
            self.fc2 = RowParallelLinear(4 * hidden, hidden,
                                         input_is_parallel=True)
            self.heads = heads
            self.hd = hidden // heads
            g = self.qkv.group
            n, r = (1, 0) if g is None else (g.nranks, g.rank)
            if heads % n:
                raise ValueError(f"{heads} heads do not divide over mp={n}")
            self.local_heads = heads // n
            self.head0 = r * self.local_heads

        def forward(self, x):
            b, s, h = x.shape
            qkv = fcollectives.all_gather(self.qkv(self.ln1(x)),
                                          self.qkv.group, axis=-1)
            qkv = qkv.reshape([b, s, 3, self.heads, self.hd])[
                :, :, :, self.head0:self.head0 + self.local_heads]
            q, k, v = qkv.unbind(2)
            att, _ = F.flash_attention(q, k, v, causal=True,
                                       training=self.training)
            x = x + self.proj(att.reshape([b, s, self.local_heads
                                           * self.hd]))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(hidden)
            self.out = nn.Linear(hidden, vocab)

        def forward(self, x):
            return self.out(self.ln(x))

    return [LayerDesc(Embed),
            *[LayerDesc(Block) for _ in range(n_layers)],
            LayerDesc(Head)]


def ce_loss(logits, labels):
    # vocab-parallel CE under mp > 1 on this rank's vocabulary columns of
    # the head's logits; plain CE at mp = 1
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ParallelCrossEntropy
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        mp_group_of, scatter_to_mp)

    local = scatter_to_mp(logits, mp_group_of(None))
    per_tok = ParallelCrossEntropy()(
        local.reshape([-1, local.shape[-1]]), labels.reshape([-1]))
    return per_tok.mean()


def strategy_for(dims, micro, recompute):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in dims.items()}
    strategy.pipeline_configs = {"accumulate_steps": micro}
    strategy.recompute = recompute
    return strategy


def global_batch(rng, vocab, batch, seq):
    """The step's global batch (numpy int32 ids and labels)."""
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return ids, labels


def model_params(model, hcg):
    """The whole model's parameter count from this rank's part: the mp
    shards summed over ``mp``, a tied weight's copies left out, the stages
    summed over ``pp``."""
    from paddle_tpu_torch.distributed import all_reduce

    dev = next(model.parameters()).device
    split = torch.zeros(1, dtype=torch.float64, device=dev)
    whole = torch.zeros(1, dtype=torch.float64, device=dev)
    for p in model.parameters():
        if getattr(p, "is_firstly_shared", True) is False:
            continue
        if getattr(p, "is_distributed", False) is True:
            split += p.numel()
        else:
            whole += p.numel()
    all_reduce(split, group=hcg.get_model_parallel_group())
    total = split + whole
    all_reduce(total, group=hcg.get_pipe_parallel_group())
    return int(total.item())


def build(args, arrays=None):
    """``fleet.init``, the rank's stage, the engine and the optimizer.
    ``arrays`` (``{"run_function.{i}.…": ndarray}``, the whole model)
    replaces the seeded initial weights. Returns (model, engine, opt,
    hcg)."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer

    dims, shape, (_, _, micro) = configs(args.real)
    fleet.init(is_collective=True,
               strategy=strategy_for(dims, micro, args.real),
               device=args.device)
    model = PipelineLayer(build_layers(*shape), num_stages=dims["pp"],
                          loss_fn=ce_loss)
    if arrays is not None:
        pipeline_stage_from_numpy(model, arrays)
    engine = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    return model, engine, opt, fleet.get_hybrid_communicate_group()


def train_in_world(args, arrays=None, log=print):
    """In a running world: :func:`build`, then ``args.steps`` steps of
    ``train_batch`` (and ``--ckpt``). Returns this rank's report: the
    losses, tokens/s after the first step, the MFU readout (None without a
    known peak) and the model's parameter count."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import get_group, save_state_dict
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        sharded_state_dict

    model, engine, opt, hcg = build(args, arrays)
    _, (_, _, _, vocab), (batch, seq, _) = configs(args.real)
    n_params = model_params(model, hcg)
    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        ids, labels = global_batch(rng, vocab, batch, seq)
        loss = engine.train_batch([torch.from_numpy(ids),
                                   torch.from_numpy(labels)], opt)
        losses.append(float(loss))
        if step == 0:
            t0 = time.perf_counter()  # the first step warms up
        log(f"step {step} loss {losses[-1]:.4f}")
    tps = mfu = None
    if args.steps > 1:
        world = torch.distributed.get_world_size()
        tps = batch * seq * (args.steps - 1) / max(
            time.perf_counter() - t0, 1e-9)
        try:
            mfu = profiler.mfu(n_params, tps / world)
        except ValueError:  # no peak known for this device
            mfu = None
        log(f"tokens/s {tps:.0f}  MFU "
            f"{'not measured (no known peak)' if mfu is None else f'{mfu:.3f}'}"
            f"  (params {n_params / 1e6:.1f}M)")
    else:
        log("(need --steps > 1 for a timed throughput window)")
    if args.ckpt:
        save_state_dict(sharded_state_dict(model), args.ckpt,
                        group=get_group())
        log(f"checkpoint written to {args.ckpt}")
    return dict(losses=losses, tokens_per_s=tps, mfu=mfu,
                n_params=n_params, model=model)


def run_rank(rank, args, world, init_method):
    from paddle_tpu_torch.distributed import (destroy_process_group,
                                              init_parallel_env)

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_parallel_env(device=args.device, backend=args.backend,
                      init_method=init_method, rank=rank, world_size=world)
    try:
        train_in_world(args, log=(lambda s: print(s, flush=True))
                       if rank == 0 else (lambda s: None))
    finally:
        destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true",
                   help="the reference's 6.7B-class shape (128 cards)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default NCCL on the card, gloo on the CPU; ranks "
                        "that share one card need gloo")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch.multiprocessing as mp

    dims, _, _ = configs(args.real)
    # the reference's layouts: its 8 devices make dp 2 in tiny mode, and
    # --real fills 128 cards with dp 1
    dp = 1 if args.real else 2
    world = dp * dims["mp"] * dims["pp"] * dims["sharding"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(run_rank, args=(args, world,
                                       f"tcp://127.0.0.1:{port}"),
                       nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
