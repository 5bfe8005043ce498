"""Evaluation metrics (``mxnet_tpu/metric.py``).

The reference's surface (``python/mxnet/metric.py``): :class:`EvalMetric`,
:class:`CompositeEvalMetric`, :class:`Accuracy`, :class:`TopKAccuracy`,
:class:`F1`, :class:`Perplexity`, :class:`MAE`, :class:`MSE`,
:class:`RMSE`, :class:`CrossEntropy`, :class:`CustomMetric`, :func:`np`
and :func:`create`.  As in the JAX package, each update computes its
batch statistic ``(sum, count)`` where the predictions lie and folds it
into accumulators there, so a training step on the card never waits for
the host; the one transfer to the host is in :meth:`EvalMetric.get` (or
a read of ``sum_metric``/``num_inst``).  ``CustomMetric`` runs the
user's numpy function, so it reads every batch back to the host.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "CustomMetric", "np", "create", "check_label_shapes"]


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
        x if isinstance(x, torch.Tensor) else torch.as_tensor(onp.asarray(x))
    return t.detach() if device is None else t.detach().to(device)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric(object):
    """Base class: ``(sum, count)`` accumulated where the predictions
    lie; subclasses implement ``_stat(label, pred)``, both tensors on
    the predictions' device.  With ``num`` the metric counts that many
    outputs apart: ``sum_metric`` and ``num_inst`` are lists, which the
    subclass's own ``update`` writes, and ``get`` names them
    ``<name>_<i>``."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def _stat(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        if self.num is not None:
            raise NotImplementedError(
                "multi-output metrics (num=%d) must override update()"
                % self.num)
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            s, n = self._stat(_tensor(label, pred.device), pred)
            self._acc.append((s, n))

    def reset(self):
        self._acc = []          # per-batch (sum, count), not yet on host
        self._host = [0.0, 0] if self.num is None \
            else [[0.0] * self.num, [0] * self.num]

    def _drain(self):
        """Fold the pending batch statistics into the host sums (the one
        transfer to the host)."""
        for s, n in self._acc:
            self._host[0] += float(s)
            self._host[1] += int(n)
        self._acc = []

    # host numbers a subclass may also write, as a user's metric that
    # counts in its own update does (``self.sum_metric += ...``)
    @property
    def sum_metric(self):
        self._drain()
        return self._host[0]

    @sum_metric.setter
    def sum_metric(self, v):
        self._drain()
        self._host[0] = v

    @property
    def num_inst(self):
        self._drain()
        return self._host[1]

    @num_inst.setter
    def num_inst(self, v):
        self._drain()
        self._host[1] = v

    def get(self):
        self._drain()
        if self.num is None:
            total, count = self._host
            return self.name, (total / count if count else float("nan"))
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        vals = [s / n if n else float("nan")
                for s, n in zip(self._host[0], self._host[1])]
        return names, vals

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


class TopKAccuracy(EvalMetric):
    """Whether the label is among the ``top_k`` highest-scoring classes.
    Only membership counts: where scores tie at the k-th place,
    ``torch.topk`` may keep another of the tied classes than the JAX
    package's ``lax.top_k`` (the lowest index)."""

    def __init__(self, **kwargs):
        top_k = kwargs.get("top_k", 1)
        if top_k <= 1:
            raise MXNetError("Please use Accuracy if top_k is no more than 1")
        self.top_k = top_k
        super().__init__("top_k_accuracy_%d" % top_k)

    def _stat(self, label, pred):
        if pred.dim() == 1:
            hits = pred.int() == label.int()
            return hits.sum().float(), label.shape[0]
        k = min(self.top_k, pred.shape[1])
        top = pred.topk(k, dim=1).indices
        hits = (top == label.int()[:, None]).any(dim=1)
        return hits.sum().float(), label.shape[0]


class F1(EvalMetric):
    """Binary F1 of the argmax prediction, scored per batch and averaged
    over batches, as the reference does; labels are 0 or 1."""

    def __init__(self):
        super().__init__("f1")

    def _stat(self, label, pred):
        y = pred.argmax(dim=1).int()
        t = label.int().ravel()
        tp = ((y == 1) & (t == 1)).sum().float()
        fp = ((y == 1) & (t == 0)).sum().float()
        fn = ((y == 0) & (t == 1)).sum().float()
        precision = torch.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = torch.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = torch.where(precision + recall > 0,
                         2 * precision * recall / (precision + recall), 0.0)
        return f1, 1


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


class _Regression(EvalMetric):
    """A per-batch regression score, averaged over batches; a 1-D label
    is a column."""

    def _stat(self, label, pred):
        if label.dim() == 1:
            label = label[:, None]
        return self._score(label.to(pred.dtype), pred).float(), 1


class MAE(_Regression):
    def __init__(self):
        super().__init__("mae")

    def _score(self, label, pred):
        return (label - pred).abs().mean()


class MSE(_Regression):
    def __init__(self):
        super().__init__("mse")

    def _score(self, label, pred):
        return (label - pred).square().mean()


class RMSE(_Regression):
    def __init__(self):
        super().__init__("rmse")

    def _score(self, label, pred):
        return (label - pred).square().mean().sqrt()


class CrossEntropy(EvalMetric):
    """Mean negative log probability of the target."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        super().__init__("cross-entropy")

    def _stat(self, label, pred):
        lab = label.long().ravel()
        picked = _pick(pred, lab)
        return -(picked + self.eps).log().sum().float(), lab.numel()


def _host(x):
    """A metric input as a numpy array on the host (bfloat16 widened to
    float32)."""
    t = _tensor(x)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class CustomMetric(EvalMetric):
    """A metric from the user's ``feval(label, pred)`` on numpy arrays,
    returning a value or ``(sum, count)``; the one metric that reads
    every batch back to the host."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs
        super().__init__(name)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            result = self._feval(_host(label), _host(pred))
            s, n = result if isinstance(result, tuple) else (result, 1)
            self._host[0] += s
            self._host[1] += n


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` of a numpy function, named after it."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy,
    "ce": CrossEntropy, "cross-entropy": CrossEntropy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
}


def create(metric, **kwargs):
    """A metric from a name, a callable ``feval(label, pred)`` (a
    :class:`CustomMetric`), an instance, or a list of these."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, **kwargs))
        return out
    if not isinstance(metric, str):
        raise TypeError("metric should be an EvalMetric, a str, a "
                        "callable or a list")
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError("Metric must be callable or one of %s"
                         % sorted(_REGISTRY))
