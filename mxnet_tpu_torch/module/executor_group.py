"""Data-parallel executor group (``mxnet_tpu/module/executor_group.py``),
for one context.

The reference binds one executor per context and slices each batch
across them; the port binds one, on one context, and raises for more
(that needs the KVStore slice).  A group bound with ``shared_group``
(a bucket of ``BucketingModule``) shares that group's parameter,
gradient and aux arrays.  The group copies each batch into its
executor's input arrays, runs forward and backward, and exposes the
parameter, gradient and output arrays to the Module.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataDesc
from ..model import KVSTORE_SLICE
from ..ndarray import NDArray


def _name(desc):
    return desc.name if isinstance(desc, DataDesc) else desc[0]


def _shape(desc):
    return desc.shape if isinstance(desc, DataDesc) else desc[1]


def _load(sources, targets):
    """Copy a batch's arrays (NDArrays or host arrays) into the bound
    input arrays, onto their device and dtype."""
    for src, dst in zip(sources, targets):
        dst._set_data(src.data if isinstance(src, NDArray)
                      else np.asarray(src))


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("training on %d contexts: %s"
                             % (len(contexts), KVSTORE_SLICE))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        # another bucket's group: its executor lends every array of the
        # same name, shape and dtype (executor.simple_bind)
        self.shared_group = shared_group
        if not for_training:
            grad_req = "null"
        data_names = [_name(x) for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" if k in self.fixed_param_names \
                        else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise MXNetError("invalid grad_req")
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes):
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = _shape(data_shapes[0])[0]
        shapes = {_name(x): _shape(x)
                  for x in list(data_shapes) + list(label_shapes or [])}
        types = {_name(x): getattr(x, "dtype", None)
                 for x in list(data_shapes) + list(label_shapes or [])}
        shared = self.shared_group
        exe = self.symbol.simple_bind(
            ctx=self.contexts[0], grad_req=self.grad_req,
            type_dict={k: v for k, v in types.items() if v is not None},
            shared_exec=shared.execs[0] if shared is not None else None,
            **shapes)
        self.execs = [exe]
        self.data_arrays = [exe.arg_dict[_name(x)] for x in data_shapes]
        self.label_arrays = [exe.arg_dict[_name(x)]
                             for x in (label_shapes or [])]
        # per parameter, one array per executor (one here), as the
        # reference's lists are
        self.param_arrays = [[exe.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[exe.grad_dict.get(n)] for n in self.param_names]
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]
        self.input_grad_arrays = [[exe.grad_dict.get(_name(x))]
                                  for x in data_shapes] \
            if self.inputs_need_grad else None

    def reshape(self, data_shapes, label_shapes):
        """Re-bind for new input shapes, carrying the parameter and aux
        values over (reference ``executor_group.py:185-196``)."""
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        exe = self.execs[0]
        arg_params = {n: exe.arg_dict[n] for n in self.param_names}
        aux_params = dict(exe.aux_dict)
        self.bind_exec(data_shapes, label_shapes)
        self.set_params(arg_params, aux_params)

    def install_monitor(self, mon):
        """A :class:`~mxnet_tpu_torch.monitor.Monitor` (or a plain
        ``callback(name, array)``) on every executor."""
        for exe in self.execs:
            if hasattr(mon, "install"):
                mon.install(exe)
            else:
                exe.install_monitor(mon)

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy the trained values into the given dicts' arrays."""
        for name, block in zip(self.param_names, self.param_arrays):
            block[0].copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            block[0].copyto(aux_params[name])

    def forward(self, data_batch, is_train=None):
        _load(data_batch.data, self.data_arrays)
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays and data_batch.label:
            _load(data_batch.label, self.label_arrays)
        self.execs[0].forward(is_train=is_train)

    def get_output_shapes(self):
        shapes = {_name(x): _shape(x)
                  for x in list(self.data_shapes)
                  + list(self.label_shapes or [])}
        _, out_shapes, _ = self.symbol.infer_shape(**shapes)
        return list(zip(self.symbol.list_outputs(),
                        (tuple(s) for s in out_shapes)))

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return [g[0] for g in self.input_grad_arrays]
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        self.execs[0].backward(out_grads=out_grads)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)
