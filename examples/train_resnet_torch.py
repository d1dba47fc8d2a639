"""Config 1 on the PyTorch/CUDA port: ResNet training through
``paddle_tpu_torch.Model.fit``, the twin of ``train_resnet.py``.

Tiny mode: ResNet-18 (10 classes) on 64 random 32x32 images, batch 16.
``--real``: ResNet-50 (1000 classes) on 1024 random 224x224 images, batch
256. Momentum 0.05 / 0.9, cross entropy, accuracy; data and weights come
from seeds.

Run on the card (the default device):
    python examples/train_resnet_torch.py --real
Run on the CPU (tiny):
    python examples/train_resnet_torch.py --device cpu
"""
import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import metric, nn, optimizer
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.vision.models import resnet

    paddle.seed(0)
    if args.real:
        net = resnet.resnet50(num_classes=1000, device=args.device)
        size, classes, n = 224, 1000, 1024
        batch = 256
    else:
        net = resnet.ResNet(resnet.BasicBlock, depth=18, num_classes=10,
                            device=args.device)
        size, classes, n = 32, 10, 64
        batch = 16

    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 3, size, size)).astype(np.float32)
    Y = rng.integers(0, classes, (n,)).astype(np.int64)

    class DS(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return X[i], Y[i]

    model = paddle.Model(net)
    model.prepare(
        optimizer=optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                     parameters=net.parameters()),
        loss=nn.CrossEntropyLoss(),
        metrics=metric.Accuracy(),
    )
    t0 = time.time()
    hist = model.fit(DS(), epochs=args.epochs, batch_size=batch, verbose=0)
    print(f"losses {['%.3f' % l for l in hist['loss']]} "
          f"({time.time() - t0:.1f}s on {model.device})")


if __name__ == "__main__":
    main()
