"""Config 2 on the PyTorch/CUDA port at ``dp`` ranks: BERT MLM training
with data parallelism, the twin of ``train_bert_dp.py``.

Each of ``dp`` rank processes (``torch.multiprocessing``, a
``torch.distributed`` world on localhost) runs ``fleet.init`` (pure dp:
``dp_degree`` inferred from the world), builds ``BertForMaskedLM`` from
seed 0 and draws every step's global batch from the same seeded stream;
``io.DistributedBatchSampler`` gives the rank its contiguous share of the
rows. The step is the reference's functional step (``functional_call``,
``torch.autograd.grad``, ``AdamW.apply_gradients_tree``), with the
gradients averaged over the dp group between the gradient and the update
(``dp_step``: one all-reduce a bucket of about 25 MB, a gradient of None
counted as zeros), so every rank applies the same update and the ranks'
parameters stay bitwise equal. The labels are the reference's (the first
``seq // 8`` positions of every row), so every row has the same count of
labelled tokens and the mean of the ranks' losses is the loss of the
global batch.

Tiny mode (default): vocab 128, 2 layers of width 32, global batch 16 x
32. ``--real``: BERT-base (dropout 0), seq 512, the reference's global
batch of 256 divided over the ranks.

    python examples/train_bert_dp_torch.py --device cpu          # tiny, dp=2
    python examples/train_bert_dp_torch.py --real --dp 8         # 8 cards
    python examples/train_bert_dp_torch.py --dp 2 --backend gloo # one card
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
    """``(BertConfig, global batch, seq)`` of the reference's two modes."""
    from paddle_tpu_torch.models.bert import BertConfig

    if real:
        return BertConfig(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0), 256, 512
    return BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0), 16, 32


def global_batch(rng, vocab, batch, seq):
    """The step's global batch (numpy): random ids, and the reference's
    labels (the first ``seq // 8`` positions are the ids, the rest
    -100)."""
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.full((batch, seq), -100, np.int32)
    labels[:, :seq // 8] = ids[:, :seq // 8]
    return ids, labels


def rank_rows(batch, rank, world):
    """This rank's rows of a global batch of ``batch``, as
    ``DistributedBatchSampler`` deals them."""
    from paddle_tpu_torch.io import DistributedBatchSampler

    sampler = DistributedBatchSampler(range(batch), batch // world,
                                      num_replicas=world, rank=rank)
    (rows,) = list(sampler)
    return rows


def dp_step(model, crit, opt, params, opt_state, ids, labels, step_i,
            group=None, lr=1e-4, bucket_mb=25):
    """One functional step on this rank's rows with the gradients averaged
    over ``group`` (None: the world): returns ``(new params, new optimizer
    state, this rank's loss, all-reduce calls)``."""
    from paddle_tpu_torch.distributed.parallel import allreduce_buckets
    from paddle_tpu_torch.jit import functional_call

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = crit(functional_call(model, leaves, ids), labels)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, leaves.values())]
    calls = allreduce_buckets(grads, group, "avg", bucket_mb)
    new_p, new_s = opt.apply_gradients_tree(params, dict(zip(leaves, grads)),
                                            opt_state, lr, step_i)
    return new_p, new_s, loss.detach(), calls


def train_in_world(args, world):
    """In a running world: ``fleet.init``, the model from seed 0, and
    ``args.steps`` data-parallel steps. Returns this rank's report: the
    global losses (the ranks' mean), tokens/s after the first step and a
    digest of the final parameters."""
    import hashlib

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import init_bert
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce, fleet
    from paddle_tpu_torch.jit import param_arrays
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion

    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(),
               device=args.device)
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_data_parallel_group()
    rank = hcg.get_data_parallel_rank()
    cfg, batch, seq = configs(args.real)
    if batch % world:
        raise ValueError(f"the global batch {batch} does not divide over "
                         f"{world} ranks")
    dev = fleet.fleet_state.mesh.device_type
    model = init_bert(cfg, seed=0, device=dev)
    model.train()
    crit = BertPretrainingCriterion(cfg.vocab_size)
    opt = optimizer.AdamW(learning_rate=1e-4)
    params = param_arrays(model)
    opt_state = opt.init_state_tree(params)
    rows = rank_rows(batch, rank, world)
    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ids, labels = global_batch(rng, cfg.vocab_size, batch, seq)
        ids = torch.from_numpy(ids[rows]).to(dev)
        labels = torch.from_numpy(labels[rows]).to(dev)
        params, opt_state, loss, _ = dp_step(model, crit, opt, params,
                                             opt_state, ids, labels, i + 1,
                                             group)
        loss = all_reduce(loss.reshape(1), op=ReduceOp.AVG, group=group)
        losses.append(float(loss))
        if i == 0:
            t0 = time.perf_counter()
    tps = batch * seq * max(1, args.steps - 1) / max(
        time.perf_counter() - t0, 1e-9)
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().contiguous().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return dict(losses=losses, tokens_per_s=tps, digest=h.hexdigest())


def run_rank(rank, args, world, init_method):
    from paddle_tpu_torch.distributed import (all_gather_object, barrier,
                                              destroy_process_group,
                                              init_parallel_env)

    init_parallel_env(device=args.device, backend=args.backend,
                      init_method=init_method, rank=rank, world_size=world)
    try:
        rep = train_in_world(args, world)
        digests = all_gather_object([], rep["digest"])
        barrier()
        if rank == 0:
            for i, loss in enumerate(rep["losses"]):
                print(f"step {i} loss {loss:.4f}")
            print(f"tokens/s {rep['tokens_per_s']:.0f} over dp={world}; "
                  f"ranks' parameters equal: {len(set(digests)) == 1}",
                  flush=True)
            if len(set(digests)) != 1:
                raise SystemExit("train_bert_dp: the ranks' parameters "
                                 "differ")
    finally:
        destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default NCCL on the card, gloo on the CPU; ranks "
                        "that share one card need gloo")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(run_rank, args=(args, args.dp,
                                       f"tcp://127.0.0.1:{port}"),
                       nprocs=args.dp, start_method="spawn")


if __name__ == "__main__":
    main()
