"""The base of the meta-parallel wrappers (after
``paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py``): a
wrapper that calls the wrapped model and hands its surface through."""
from __future__ import annotations


class MetaParallelBase:
    def __init__(self, layers, hcg=None, strategy=None):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        # only reached for names the wrapper lacks
        if name.startswith("__") or name == "_layers":
            raise AttributeError(name)
        return getattr(self._layers, name)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self
