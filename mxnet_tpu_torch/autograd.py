"""Imperative autograd (``mxnet_tpu/autograd.py``) on torch autograd.

The reference records each imperative op on a tape (``AutogradRuntime``,
``src/ndarray/autograd.h:51-98``) and replays it backwards; the JAX
package keeps its own tape and replays it through ``jax.vjp``.  Here
torch autograd is the tape: a marked variable's tensor is a leaf that
requires a gradient, every op body called inside :func:`record` runs
under torch autograd (``op/invoke.py``), and :func:`backward` asks torch
for the gradients of the marked variables and writes them into their
gradient arrays per ``grad_req``.  Inside :func:`pause`, or outside
:func:`record`, op bodies run without autograd.  ``train_mode`` selects
the ops' training behaviour (Dropout) independently of recording.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]

_STATE = threading.local()
# the marked variables by id; each holds its gradient array in ``grad``
# and its request in ``_grad_req``
_MARKED = weakref.WeakValueDictionary()


def _state():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording():
    return _state().recording


def is_training():
    return _state().training


def set_recording(is_rec):
    """Set recording on or off; returns the previous state."""
    prev = _state().recording
    _STATE.recording = bool(is_rec)
    return prev


def set_training(train_mode):
    """Set training mode on or off; returns the previous state."""
    prev = _state().training
    _STATE.training = bool(train_mode)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._recording = recording
        self._training = training

    def __enter__(self):
        st = _state()
        self._prev = (st.recording, st.training)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        return self

    def __exit__(self, *args):
        _state().recording, _state().training = self._prev


def record(train_mode=True):
    """``with autograd.record():`` records the ops run inside it
    (reference ``c_api.h:534``)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """``with autograd.pause():`` runs ops without recording them."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf of the recorded computation, with its
    gradient array (reference ``MXAutogradMarkVariables``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gbuf, req in zip(variables, gradients, grad_reqs):
        if not var.data.is_floating_point():
            raise MXNetError("cannot differentiate an array of dtype %s"
                             % var.dtype)
        var._data = var.data.detach().requires_grad_()
        var.grad, var._grad_req = gbuf, req
        _MARKED[id(var)] = var


def _head_grads(heads, head_grads):
    from .ndarray import NDArray
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs = []
    for h, g in zip(heads, head_grads):
        if g is None:
            outs.append(torch.ones_like(h.data))
        else:
            g = g.data if isinstance(g, NDArray) else torch.as_tensor(g)
            outs.append(g.to(device=h.data.device, dtype=h.dtype))
    return outs


def _recorded(heads):
    tensors = [h.data for h in heads]
    if not any(t.grad_fn is not None for t in tensors):
        raise MXNetError("no computation recorded: run the ops inside "
                         "autograd.record() on arrays that attach_grad")
    return tensors


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every marked variable's gradient array
    (reference ``AutogradRuntime::ComputeGradient``); a missing head
    gradient is ones."""
    tensors = _recorded(heads)
    cots = _head_grads(heads, head_grads)
    pairs = [(t, g) for t, g in zip(tensors, cots) if t.requires_grad]
    marked = [var for var in list(_MARKED.values())
              if var._grad_req != "null" and var.data.requires_grad]
    if not marked:
        return
    grads = torch.autograd.grad([t for t, _ in pairs],
                                [var.data for var in marked],
                                [g for _, g in pairs],
                                retain_graph=retain_graph, allow_unused=True)
    for var, g in zip(marked, grads):
        if g is None:
            continue
        if var._grad_req == "add":
            var.grad._set_data(var.grad.data + g)
        else:
            var.grad._set_data(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` as new
    NDArrays, written into no gradient array."""
    from .ndarray import NDArray
    tensors = _recorded(heads)
    cots = _head_grads(heads, head_grads)
    pairs = [(t, g) for t, g in zip(tensors, cots) if t.requires_grad]
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad([t for t, _ in pairs],
                                [v.data for v in variables],
                                [g for _, g in pairs],
                                retain_graph=retain_graph,
                                create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v.data) if g is None
                    else (g if create_graph else g.detach()))
            for v, g in zip(variables, grads)]
