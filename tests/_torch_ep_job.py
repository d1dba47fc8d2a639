"""A training job for the port's launcher tests: one LayerNorm -> MoELayer
(4 ``ExpertFFN`` experts, GShard top-2) -> residual block at ep = the
world size, on the CPU over gloo, started by ``python -m
paddle_tpu_torch.distributed.launch`` (which sets the ``PADDLE_*``
environment it reads).

    python tests/_torch_ep_job.py OUT [--die-after STEP]

Each step is AdamW through ``fleet.distributed_optimizer`` with the MoE
clip, on the rank's rows of one global batch; after each step both ranks
save the model and the optimizer (``save_state_dict(group=)``, each rank
its experts under their global names) to ``OUT/ckpt/step-N``. A started
job resumes from the latest committed step. With ``--die-after S`` rank
1 exits with code 17 right after step S's checkpoint, once: it leaves a
marker in ``OUT`` so the restarted world runs on. At the end each rank
writes its parameters to ``OUT/final.rank{r}.pt``, then runs the same
job again in memory, from the start and without checkpoints, and writes
those parameters to ``OUT/uninterrupted.rank{r}.pt``.
"""
import argparse
import datetime
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

D, F, E, T, STEPS = 8, 16, 4, 12, 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--die-after", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.convert import moe_from_numpy
    from paddle_tpu_torch.distributed import (checkpoint, fleet, get_group,
                                              get_rank, get_world_size,
                                              init_parallel_env,
                                              load_state_dict,
                                              save_state_dict)
    from paddle_tpu_torch.incubate.distributed.models import moe

    init_parallel_env(device="cpu",
                      timeout=datetime.timedelta(seconds=60))
    fleet.init(is_collective=True, device="cpu")
    rank, world = get_rank(), get_world_size()

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = nn.LayerNorm(D, device="cpu")
            self.moe = moe.MoELayer(
                D, [moe.ExpertFFN(D, F, "silu", device="cpu")
                    for _ in range(E)],
                gate=moe.GShardGate(D, E, random_routing=False,
                                    device="cpu"), capacity_factor=0.75)

        def forward(self, x):
            return x + self.moe(self.norm(x))

    def build():
        model = Block().train()
        moe_from_numpy(model, _global_weights())
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-2, parameters=list(model.named_parameters()),
            grad_clip=moe.ClipGradForMOEByGlobalNorm(1.0)))
        return model, opt

    g = np.random.default_rng(1)
    batches = [g.standard_normal((world * T, D)).astype(np.float32)
               for _ in range(STEPS)]

    def train(model, opt, first, on_step=lambda step: None):
        for step in range(first, STEPS + 1):
            x = torch.from_numpy(batches[step - 1][rank * T:(rank + 1) * T])
            y = model(x)
            loss = (y * y).mean() + 0.01 * model.moe.gate.get_loss()
            loss.backward()
            opt.step()
            opt.clear_grad()
            on_step(step)
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    model, opt = build()
    root = os.path.join(args.out, "ckpt")
    start = checkpoint.latest_step(root) or 0
    if start:
        state = load_state_dict(checkpoint.step_dir(root, start))
        moe_from_numpy(model, {k[6:]: v for k, v in state.items()
                               if k.startswith("model.")})
        opt.set_state_dict({k[4:]: v for k, v in state.items()
                            if k.startswith("opt.")})

    def save_and_maybe_die(step):
        state = {f"model.{k}": v for k, v in model.state_dict().items()}
        state.update({f"opt.{k}": v for k, v in opt.state_dict().items()})
        save_state_dict(state, checkpoint.step_dir(root, step),
                        group=get_group())
        marker = os.path.join(args.out, "died")
        if step == args.die_after and rank == 1 and \
                not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(17)

    torch.save(train(model, opt, start + 1, save_and_maybe_die),
               os.path.join(args.out, f"final.rank{rank}.pt"))
    torch.save(train(*build(), 1),
               os.path.join(args.out, f"uninterrupted.rank{rank}.pt"))
    print(f"rank {rank} done from step {start}", flush=True)


def _global_weights():
    """The whole model's weights by global name (every expert's), from a
    numpy seed."""
    names = {"norm.weight": (D,), "norm.bias": (D,),
             "moe.gate.gate.weight": (D, E), "moe.gate.gate.bias": (E,)}
    for e in range(E):
        names.update({f"moe.experts.{e}.fc1.weight": (D, F),
                      f"moe.experts.{e}.fc1.bias": (F,),
                      f"moe.experts.{e}.fc2.weight": (F, D),
                      f"moe.experts.{e}.fc2.bias": (D,)})
    r = np.random.default_rng(0)
    return {n: (0.5 * r.standard_normal(s)).astype(np.float32)
            for n, s in sorted(names.items())}


if __name__ == "__main__":
    main()
