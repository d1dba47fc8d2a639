"""Streaming metrics, after ``paddle_tpu/metric/__init__.py``. State is
kept on the host in numpy; ``Accuracy.compute`` ranks on the tensor's own
device (``torch.topk``) and hands ``update`` a small boolean array.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        """``[..., maxk]`` booleans: whether each of the top ``maxk``
        classes is the label."""
        pred = _t(pred)
        label = _t(label).to(pred.device)
        if label.dim() == pred.dim() and label.shape[-1] == 1:
            label = label[..., 0]
        top = torch.topk(pred, self.maxk, dim=-1).indices
        return top == label[..., None]

    def update(self, correct):
        correct = _np(correct)
        n = correct.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(axis=-1).sum()
            self.count[i] += n
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = self.total / np.maximum(self.count, 1)
        return float(accs[0]) if len(self.topk) == 1 else [float(a) for a in accs]

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """Bucketed ROC-AUC (reference: paddle.metric.Auc num_thresholds)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:
            preds = preds[:, -1]  # prob of positive class
        labels = _np(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._pos[i] += 1
            else:
                self._neg[i] += 1

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # sum over buckets of trapezoid areas, descending threshold
        tp = fp = 0
        area = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_tp = tp + self._pos[i]
            new_fp = fp + self._neg[i]
            area += (new_fp - fp) * (tp + new_tp) / 2.0
            tp, fp = new_tp, new_fp
        return float(area / (tot_pos * tot_neg))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy, a 0-d f32 tensor on ``input``'s
    device."""
    pred = _t(input)
    lab = _t(label).to(pred.device)
    if lab.dim() == pred.dim() and lab.shape[-1] == 1:
        lab = lab[..., 0]
    top = torch.topk(pred, k, dim=-1).indices
    return (top == lab[..., None]).any(dim=-1).float().mean()
