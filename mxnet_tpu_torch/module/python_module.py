"""Modules computed in Python (``mxnet_tpu/module/python_module.py``):
:class:`PythonModule` and :class:`PythonLossModule`, stages spliced into
a module chain.

Reference ``python/mxnet/module/python_module.py``.  They own no
parameters and no device state: the only arrays they hold are the ones
``forward`` was given.  The shapes live in one ``_ports`` dict keyed by
role ("data", "label", "output").
"""
from __future__ import annotations

import logging

from .. import ndarray
from ..ndarray import NDArray
from .base_module import BaseModule


class PythonModule(BaseModule):
    """Base of the modules whose computation is plain Python
    (reference ``python_module.py:14``): subclasses implement
    ``forward``, ``backward`` and ``_compute_output_shapes``; the
    parameter and optimizer lifecycle is a no-op."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._names = {"data": list(data_names),
                       "label": list(label_names or []),
                       "output": list(output_names)}
        self._ports = {"data": None, "label": None, "output": None}

    @property
    def data_names(self):
        return self._names["data"]

    @property
    def output_names(self):
        return self._names["output"]

    @property
    def data_shapes(self):
        return self._ports["data"]

    @property
    def label_shapes(self):
        return self._ports["label"]

    @property
    def output_shapes(self):
        return self._ports["output"]

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._ports["label"] is not None:
            eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        pass

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("PythonModule already bound; skipping")
            return
        if grad_req != "write":
            raise ValueError("python modules only support grad_req='write'")
        got = [name for name, _ in data_shapes]
        if got != self._names["data"]:
            raise ValueError("data_shapes %s do not match data_names %s"
                             % (got, self._names["data"]))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._ports["data"] = data_shapes
        self._ports["label"] = label_shapes
        self._ports["output"] = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """The ``(name, shape)`` list of the outputs, from the bound
        input shapes."""
        raise NotImplementedError


class PythonLossModule(PythonModule):
    """A terminal loss stage computed in Python (reference
    ``python_module.py:198``): ``forward`` passes the scores through,
    ``backward`` takes the input gradient from the user's
    ``grad_func(scores, labels)``, which is required.  A gradient given
    as a numpy array (or an NDArray elsewhere) lands on the scores'
    context: the card's, when the stage before it runs there."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise ValueError("loss module takes exactly one data and one "
                             "label input")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func
        self._scores = self._labels = self._grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._ports["data"][0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if self.for_training if is_train is None else is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("a loss module is terminal; out_grads must be "
                             "None")
        assert self.for_training
        if self._grad_func is None:
            raise NotImplementedError(
                "PythonLossModule needs grad_func(scores, labels) to "
                "compute the input gradient")
        grad = self._grad_func(self._scores, self._labels)
        ctx = self._scores.context
        self._grad = (grad.as_in_context(ctx)
                      if isinstance(grad, NDArray)
                      else ndarray.array(grad, ctx=ctx))

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._grad]

    def install_monitor(self, mon):
        raise NotImplementedError("python loss modules have no executor to "
                                  "tap")
