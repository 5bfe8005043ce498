"""Evaluation metrics (``mxnet_tpu/metric.py``).

The reference's surface (``python/mxnet/metric.py``): :class:`EvalMetric`,
:class:`CompositeEvalMetric`, :class:`Accuracy`, :class:`Perplexity`,
:class:`CrossEntropy` and :func:`create`.  As in the JAX package, each
update computes its batch statistic ``(sum, count)`` where the
predictions lie and folds it into accumulators there, so a training step
on the card never waits for the host; the one transfer to the host is in
:meth:`EvalMetric.get` (or a read of ``sum_metric``/``num_inst``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "Perplexity",
           "CrossEntropy", "create", "check_label_shapes"]


def check_label_shapes(labels, preds, shape=0):
    """Raise if label/pred lists (or arrays, ``shape=1``) disagree."""
    a = len(labels) if shape == 0 else labels.shape
    b = len(preds) if shape == 0 else preds.shape
    if a != b:
        raise ValueError(
            "labels %s vs predictions %s mismatch" % (str(a), str(b)))


def _tensor(x, device=None):
    """A metric input as a tensor (on ``device`` when given), no copy
    where it already is one there."""
    t = x.data if isinstance(x, NDArray) else \
        x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.detach() if device is None else t.detach().to(device)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric(object):
    """Base class: ``(sum, count)`` accumulated where the predictions
    lie; subclasses implement ``_stat(label, pred)``, both tensors on
    the predictions' device."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def _stat(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            s, n = self._stat(_tensor(label, pred.device), pred)
            self._acc.append((s, n))

    def reset(self):
        self._acc = []          # per-batch (sum, count), not yet on host
        self._host = [0.0, 0]

    def _drain(self):
        """Fold the pending batch statistics into the host sums (the one
        transfer to the host)."""
        for s, n in self._acc:
            self._host[0] += float(s)
            self._host[1] += int(n)
        self._acc = []

    @property
    def sum_metric(self):
        self._drain()
        return self._host[0]

    @property
    def num_inst(self):
        self._drain()
        return self._host[1]

    def get(self):
        self._drain()
        total, count = self._host
        return self.name, (total / count if count else float("nan"))

    def get_name_value(self):
        name, value = self.get()
        name = name if isinstance(name, list) else [name]
        value = value if isinstance(value, list) else [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Several metrics driven as one (reference ``metric.py:86``)."""

    def __init__(self, metrics=None):
        self.metrics = list(metrics or [])
        super().__init__("composite")

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        super().reset()

    def get(self):
        pairs = [m.get() for m in self.metrics]
        return [p[0] for p in pairs], [p[1] for p in pairs]


class Accuracy(EvalMetric):
    """Classification accuracy; rows of class scores are argmaxed when
    the prediction's shape differs from the label's."""

    def __init__(self):
        super().__init__("accuracy")

    def _stat(self, label, pred):
        if pred.shape != label.shape:
            pred = pred.argmax(dim=1)
        hits = pred.int().ravel() == label.int().ravel()
        return hits.sum().float(), hits.numel()


def _pick(pred, lab):
    """``pred[i, lab[i]]`` per row, a negative label counting from the
    last class as the JAX package's ``take_along_axis`` does (so an
    ignored ``-1`` padding label never indexes out of bounds)."""
    lab = torch.where(lab < 0, lab + pred.shape[1], lab)
    return pred.gather(1, lab[:, None])[:, 0]


class Perplexity(EvalMetric):
    """``exp`` of the mean negative log probability of the target, with
    an optional ignored padding label."""

    def __init__(self, ignore_label, axis=-1):
        self.ignore_label = ignore_label
        self.axis = axis
        super().__init__("Perplexity")

    def _stat(self, label, pred):
        lab = label.long().ravel()
        if pred.dim() > 2:
            pred = pred.reshape(-1, pred.shape[-1])
        probs = _pick(pred, lab)
        if self.ignore_label is not None:
            keep = lab != self.ignore_label
            probs = torch.where(keep, probs, torch.ones_like(probs))
            count = keep.sum()
        else:
            count = lab.numel()
        loss = -probs.clamp(min=1e-10).log().sum()
        return loss.float(), count

    def get(self):
        self._drain()
        total, count = self._host
        if not count:
            return self.name, float("nan")
        return self.name, math.exp(total / count)


class CrossEntropy(EvalMetric):
    """Mean negative log probability of the target."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        super().__init__("cross-entropy")

    def _stat(self, label, pred):
        lab = label.long().ravel()
        picked = _pick(pred, lab)
        return -(picked + self.eps).log().sum().float(), lab.numel()


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy,
    "ce": CrossEntropy, "cross-entropy": CrossEntropy,
    "perplexity": Perplexity,
}


def create(metric, **kwargs):
    """A metric from a name, an instance, or a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, **kwargs))
        return out
    if not isinstance(metric, str):
        raise TypeError("metric should be an EvalMetric, a str or a list")
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError("Metric must be one of %s" % sorted(_REGISTRY))
