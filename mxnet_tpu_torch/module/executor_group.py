"""Data-parallel executor group (``mxnet_tpu/module/executor_group.py``).

Reference ``python/mxnet/module/executor_group.py:77-652``: one executor
per context, each bound to its slice of the batch (``decide_slices``,
proportional to the work load list), forward and backward per slice, the
outputs merged along the batch axis.  The Module merges the executors'
gradients through a KVStore (``model._update_params``).  Two contexts may
name one device (``[gpu(0), gpu(0)]``), as the reference lets two
executors share a device.  A group bound with ``shared_group`` (a bucket
of ``BucketingModule``) shares that group's parameter, gradient and aux
arrays, executor by executor.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError
from ..executor_manager import _load_general, _split_input_slice
from ..io import DataDesc
from ..ndarray import NDArray, concatenate


def _name(desc):
    return desc.name if isinstance(desc, DataDesc) else desc[0]


def _shape(desc):
    return desc.shape if isinstance(desc, DataDesc) else desc[1]


def _merge_multi_context(outputs, major_axis):
    """Per-executor outputs concatenated along the batch axis (reference
    ``executor_group.py:28-50``), on the first executor's device."""
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if axis >= 0 and len(tensors) > 1:
            first = tensors[0].data.device
            rets.append(concatenate(
                [NDArray(t.data.to(first)) for t in tensors], axis=axis,
                always_copy=False))
        else:
            rets.append(tensors[0])
    return rets


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", workload=None):
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = workload or [1] * len(self.contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        # another bucket's group: its executors lend every array of the
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
        self.batch_size = None
        self.slices = None
        self.bind_exec(data_shapes, label_shapes)

    def decide_slices(self, data_shapes):
        """Workload-proportional batch slices (reference
        ``executor_group.py:207-236``); each input's batch axis from its
        layout."""
        assert len(data_shapes) > 0
        major_axis = [DataDesc.get_batch_axis(getattr(x, "layout", "NCHW"))
                      for x in data_shapes]
        for desc, axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            found = _shape(desc)[axis]
            if self.batch_size is None:
                self.batch_size = found
                self.slices = _split_input_slice(found, self.workload)
            else:
                assert found == self.batch_size, \
                    ("all data must have the same batch size: batch_size = "
                     "%d, but %s has shape %s"
                     % (self.batch_size, _name(desc), _shape(desc)))
        return major_axis

    def _sliced_shapes(self, shapes, i, major_axis):
        out = {}
        for desc, axis in zip(shapes, major_axis):
            shape = list(_shape(desc))
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            out[_name(desc)] = tuple(shape)
        return out

    def bind_exec(self, data_shapes, label_shapes):
        self.batch_size = None
        self.data_layouts = self.decide_slices(data_shapes)
        self.label_layouts = self.decide_slices(label_shapes) \
            if label_shapes else []
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        types = {_name(x): getattr(x, "dtype", None)
                 for x in list(data_shapes) + list(label_shapes or [])}
        shared = self.shared_group
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            shapes = self._sliced_shapes(data_shapes, i, self.data_layouts)
            shapes.update(self._sliced_shapes(label_shapes or [], i,
                                              self.label_layouts))
            self.execs.append(self.symbol.simple_bind(
                ctx=ctx, grad_req=self.grad_req,
                type_dict={k: v for k, v in types.items() if v is not None},
                shared_exec=shared.execs[i] if shared is not None else None,
                **shapes))
        # per input, the (slice, array) of every executor
        self.data_arrays = [[(self.slices[i], e.arg_dict[_name(x)])
                             for i, e in enumerate(self.execs)]
                            for x in data_shapes]
        self.label_arrays = [[(self.slices[i], e.arg_dict[_name(x)])
                              for i, e in enumerate(self.execs)]
                             for x in (label_shapes or [])]
        # per parameter, one array per executor, as the reference's lists
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]
        self.input_grad_arrays = [[e.grad_dict.get(_name(x))
                                   for e in self.execs]
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
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """The executors' values averaged into the given dicts' arrays
        (reference ``executor_group.py:337-354``); one executor's are
        copied as they are."""
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if len(block) == 1:
                    block[0].copyto(out[name])
                    continue
                dev = block[0].data.device
                acc = block[0].data.clone()
                for w in block[1:]:
                    acc += w.data.to(dev)
                out[name]._set_data(acc / len(block))

    def forward(self, data_batch, is_train=None):
        _load_general(data_batch.data, self.data_arrays)
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)
        for exe in self.execs:
            exe.forward(is_train=is_train)

    @property
    def output_layouts(self):
        return [0] * len(self.symbol.list_outputs())

    def get_output_shapes(self):
        shapes = {_name(x): _shape(x)
                  for x in list(self.data_shapes)
                  + list(self.label_shapes or [])}
        _, out_shapes, _ = self.symbol.infer_shape(**shapes)
        return list(zip(self.symbol.list_outputs(),
                        (tuple(s) for s in out_shapes)))

    def get_outputs(self, merge_multi_context=True):
        per_output = [[e.outputs[i] for e in self.execs]
                      for i in range(len(self.execs[0].outputs))]
        if not merge_multi_context:
            return per_output
        return _merge_multi_context(per_output, self.output_layouts)

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays,
                                        self.data_layouts)
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        if out_grads is None:
            out_grads = []
        elif isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        for i, exe in enumerate(self.execs):
            sliced = [NDArray(g.data[self.slices[i]]) if axis == 0 else g
                      for g, axis in zip(out_grads, self.output_layouts)]
            exe.backward(out_grads=sliced or None)

    def update_metric(self, eval_metric, labels):
        for exe, islice in zip(self.execs, self.slices):
            labels_slice = [
                NDArray((label.data if isinstance(label, NDArray)
                         else torch.as_tensor(np.asarray(label)))[islice])
                for label in labels]
            eval_metric.update(labels_slice, exe.outputs)
