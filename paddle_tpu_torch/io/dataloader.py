"""DataLoader, after ``paddle_tpu/io/dataloader.py``.

Host pipeline: the batch sampler's index lists, a collate function that
stacks numpy samples (``default_collate_fn``), then CPU tensors, in
pinned memory when ``pin_memory`` (``hapi.Model`` asks for it when the
network is on the card, so the copy to the device can run
asynchronously). Batches come out as the reference's do: a sample's
tuple becomes a list of tensors.

``num_workers=0`` collates in the calling thread. With workers, the
loader wraps ``torch.utils.data.DataLoader`` with this loader's own
``BatchSampler`` as its ``batch_sampler``, so the batches and their order
stay the reference's; its spawned worker processes and pin thread stand
in for the reference's shared-memory pool. An ``IterableDataset`` is
always read in the calling thread, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays (nested tuples, lists and
    dicts keep their structure; ints become int64, floats float32)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, torch.Tensor):
        return np.stack([t.detach().cpu().numpy() for t in batch])
    return np.asarray(batch)


def _to_torch(batch, pin: bool):
    """A collated batch as CPU tensors (tuples become lists)."""
    if isinstance(batch, (tuple, list)):
        return [_to_torch(b, pin) for b in batch]
    if isinstance(batch, dict):
        return {k: _to_torch(v, pin) for k, v in batch.items()}
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    return t.pin_memory() if pin else t


class _TorchCollate:
    """``collate_fn`` then tensors, in a worker process (picklable)."""

    def __init__(self, collate_fn):
        self.collate_fn = collate_fn

    def __call__(self, samples):
        return _to_torch(self.collate_fn(samples), False)


class DataLoader:
    def __init__(self, dataset: Dataset,
                 batch_sampler: Optional[BatchSampler] = None, batch_size=1,
                 shuffle=False, drop_last=False,
                 collate_fn: Optional[Callable] = None, num_workers=0,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 persistent_workers=False, pin_memory=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = bool(persistent_workers)
        self.pin_memory = bool(pin_memory)
        self._workers = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _batches(self):
        """Collated numpy batches, read in the calling thread."""
        if self._iterable:
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf)
                    buf = []
            if buf and not self.drop_last:
                yield self.collate_fn(buf)
            return
        for idxs in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in idxs])

    def _worker_loader(self):
        """The ``torch.utils.data.DataLoader`` over this loader's batch
        sampler (kept across epochs when ``persistent_workers``)."""
        if self._workers is None:
            self._workers = torch.utils.data.DataLoader(
                self.dataset, batch_sampler=self.batch_sampler,
                collate_fn=_TorchCollate(self.collate_fn),
                num_workers=self.num_workers, pin_memory=self.pin_memory,
                timeout=self.timeout, worker_init_fn=self.worker_init_fn,
                multiprocessing_context="spawn",
                persistent_workers=self.persistent_workers,
                prefetch_factor=self.prefetch_factor)
        loader = self._workers
        if not self.persistent_workers:
            self._workers = None
        return loader

    def close(self):
        """Let go of a persistent worker pool (its processes stop with its
        last iterator)."""
        self._workers = None

    def __iter__(self):
        if self.num_workers and not self._iterable:
            yield from self._worker_loader()
            return
        for batch in self._batches():
            yield _to_torch(batch, self.pin_memory)
