"""Config 5 on the PyTorch/CUDA port: ``to_static`` → ``jit.save`` /
``jit.load`` → ``inference.Predictor``, the twin of
``to_static_export.py`` with the same ``TinyTransformer`` (d 64, 4 heads
of 16, 2 layers, vocab 256) and the same three checks.

``to_static`` is ``torch.compile(fullgraph=True)``; ``jit.save`` writes
``<prefix>.pt2`` (``torch.export``, the weights an input) and
``<prefix>.pdiparams``; the Predictor runs the loaded program. Attention
runs the flash forward kernel (#2, at head dim 16) in all three. Weights
are random from a seed.

Run on the card (the default device):
    python examples/to_static_export_torch.py
Run on the CPU:
    python examples/to_static_export_torch.py --device cpu
"""
import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import nn


class TinyTransformer(torch.nn.Module):
    def __init__(self, d=64, heads=4, layers=2, vocab=256, device=None):
        super().__init__()
        self.emb = nn.Embedding(vocab, d, device=device)
        enc = nn.TransformerEncoderLayer(d, heads, 4 * d, dropout=0.0,
                                         device=device)
        self.encoder = nn.TransformerEncoder(enc, layers)
        self.head = nn.Linear(d, vocab, device=device)

    def forward(self, ids):
        return self.head(self.encoder(self.emb(ids)))


@torch.no_grad()
def init_tiny(model, seed=0, std=0.1):
    """Every matrix normal(0, ``std``) from ``seed``; biases stay zero and
    LayerNorm scales one."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in model.parameters():
        if p.dim() > 1:
            p.normal_(0.0, std, generator=gen)
    return model


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.jit import InputSpec, load, save, to_static

    dev = resolve_device(args.device)
    model = init_tiny(TinyTransformer(device=dev)).eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int32)).to(dev)

    # 1) to_static: the compiled callable
    static_fn = to_static(model)
    with torch.no_grad():
        eager_out = model(ids)
        static_out = static_fn(ids)
    np.testing.assert_allclose(eager_out.cpu().numpy(),
                               static_out.cpu().numpy(), atol=1e-5)
    print("to_static == eager ok")

    with tempfile.TemporaryDirectory() as d:
        # 2) export and reload via jit.save / jit.load
        prefix = os.path.join(d, "tiny")
        save(model, prefix, input_spec=[InputSpec([2, 16], "int32")])
        reloaded = load(prefix, device=dev)
        np.testing.assert_allclose(reloaded(ids).cpu().numpy(),
                                   eager_out.cpu().numpy(), atol=1e-5)
        print("jit.save/load round-trip ok  artifact:", prefix + ".pt2")

        # 3) serve through the Predictor API
        config = Config(prefix)
        if dev.type == "cpu":
            config.disable_gpu()
        pred = create_predictor(config)
        outs = pred.run([ids.cpu().numpy()])
        np.testing.assert_allclose(outs[0], eager_out.cpu().numpy(),
                                   atol=1e-5)
        print("inference.Predictor ok")


if __name__ == "__main__":
    main()
