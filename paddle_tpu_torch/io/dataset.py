"""Dataset abstractions, after ``paddle_tpu/io/dataset.py``: samples are
numpy arrays (a torch tensor given to ``TensorDataset`` is copied to the
host)."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
import torch


class Dataset:
    """Map-style dataset: implement ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: implement ``__iter__``."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset does not support indexing")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrs = []
        for t in tensors:
            if isinstance(t, torch.Tensor):
                arrs.append(t.detach().cpu().numpy())
            else:
                arrs.append(np.asarray(t))
        n = len(arrs[0])
        if any(len(a) != n for a in arrs):
            raise ValueError("all tensors must share dim 0")
        self._arrays = arrs

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self._arrays)

    def __len__(self):
        return len(self._arrays[0])


class ComposeDataset(Dataset):
    """Zip datasets column-wise."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("empty datasets")
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("datasets must have equal length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets row-wise."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        self._cum: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self._cum.append(total)

    def __len__(self):
        return self._cum[-1] if self._cum else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self._cum, idx)
        prev = self._cum[di - 1] if di else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    rng = np.random.default_rng(None if generator is None else generator)
    perm = rng.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out
