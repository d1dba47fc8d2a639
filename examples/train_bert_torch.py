"""Config 2 on the PyTorch/CUDA port at one GPU: BERT MLM training, the
one-GPU twin of ``train_bert_dp.py`` (whose data parallelism is not
ported yet).

The step is functional, as the reference's: ``jit.functional_call`` of
``BertForMaskedLM`` on an explicit parameter dict, ``torch.autograd.grad``
of ``BertPretrainingCriterion``, then ``AdamW.apply_gradients_tree``
(learning rate 1e-4) returning new parameters and optimizer state. It runs
eagerly (compiling it is later work). Labels are the reference's: the
first ``seq // 8`` positions keep their token, the rest are -100.
``--recompute`` runs every encoder layer under ``fleet.recompute``.

Tiny mode (default): vocab 128, 2 layers of width 32, batch 16 x 32.
``--real``: BERT-base (12 layers, 768 wide, 12 heads, vocab 30522, dropout
0 as in the reference's ``--real``), seq 512, batch 32 (one GPU's share of
the reference's 256 over an 8-way data-parallel mesh).

Run on the card (the default device):
    python examples/train_bert_torch.py --real
Run on the CPU (tiny):
    python examples/train_bert_torch.py --device cpu
"""
import argparse
import functools
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import time

import numpy as np
import torch


def configs(real):
    """``(BertConfig, batch, seq)`` of the reference's two modes."""
    from paddle_tpu_torch.models.bert import BertConfig

    if real:
        return BertConfig(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0), 32, 512
    return BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0), 16, 32


def mlm_batch(rng, vocab, batch, seq, device):
    """Random ids and the reference's labels: the first ``seq // 8``
    positions are the ids, the rest -100."""
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.full((batch, seq), -100, np.int32)
    labels[:, :seq // 8] = ids[:, :seq // 8]
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def use_recompute(model):
    """Run each encoder layer of ``model`` (a ``BertForMaskedLM``) under
    ``fleet.recompute``; the parameter names do not change."""
    from paddle_tpu_torch.distributed.fleet.recompute import recompute

    for layer in model.bert.encoder.layers:
        layer.forward = functools.partial(recompute, layer.forward)


def mlm_step(model, crit, opt, params, opt_state, ids, labels, step_i,
             lr=1e-4):
    """One functional step: returns ``(new params, new optimizer state,
    loss)``; ``params`` and ``opt_state`` are not written."""
    from paddle_tpu_torch.jit import functional_call

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    logits = functional_call(model, leaves, ids)
    loss = crit(logits, labels)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = dict(zip(leaves, grads))
    new_p, new_s = opt.apply_gradients_tree(params, grads, opt_state, lr,
                                            step_i)
    return new_p, new_s, loss.detach()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--recompute", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import init_bert
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.jit import param_arrays
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion

    dev = resolve_device(args.device)
    cfg, batch, seq = configs(args.real)
    model = init_bert(cfg, seed=0, device=dev)
    model.train()
    if args.recompute:
        use_recompute(model)
    crit = BertPretrainingCriterion(cfg.vocab_size)
    opt = optimizer.AdamW(learning_rate=1e-4)
    params = param_arrays(model)
    opt_state = opt.init_state_tree(params)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.steps):
        ids, labels = mlm_batch(rng, cfg.vocab_size, batch, seq, dev)
        params, opt_state, loss = mlm_step(model, crit, opt, params,
                                           opt_state, ids, labels, i + 1)
        loss = float(loss)
        if i == 0:
            t0 = time.perf_counter()
        print(f"step {i} loss {loss:.4f}")
    tps = batch * seq * max(1, args.steps - 1) / max(
        time.perf_counter() - t0, 1e-9)
    print(f"tokens/s {tps:.0f} on {dev}")


if __name__ == "__main__":
    main()
