"""Module (``mxnet_tpu/module/module.py``): the training surface over a
Symbol, on the classic executor path.

Reference ``python/mxnet/module/module.py:323-565``.  One executor on
one context (:class:`DataParallelExecutorGroup`), gradients from its
backward, and the optimizer applied per parameter by a local updater
(one device needs no KVStore, as in the reference).  This is the path
the JAX package takes on any context but a TPU.  Its fused path (the
whole step as one program, ``parallel.Trainer``) is not ported yet: a
mesh context, ``MXTPU_MODULE_FUSED=always`` or a ``compute_dtype``
raises, naming the fused trainer slice, instead of training another
way.
"""
from __future__ import annotations

import logging
import os
import warnings

from .. import optimizer as opt
from ..base import Context, MXNetError, current_context
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from ..model import _create_kvstore, _update_params, load_checkpoint
from ..ndarray import zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

FUSED_SLICE = ("the fused trainer (the whole step as one program, with a "
               "CUDA-graph capture) is not ported yet: it comes with the "
               "port's fused Trainer slice")


class Module(BaseModule):
    """Module over a Symbol (reference ``module.py:31-90``)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        if compute_dtype or os.environ.get("MXTPU_COMPUTE_DTYPE"):
            raise MXNetError("compute_dtype: %s" % FUSED_SLICE)
        if os.environ.get("MXTPU_MODULE_FUSED", "auto") == "always":
            raise MXNetError("MXTPU_MODULE_FUSED=always: %s" % FUSED_SLICE)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        elif not (isinstance(context, (list, tuple))
                  and all(isinstance(c, Context) for c in context)):
            raise MXNetError("context %r (a mesh?): %s"
                             % (context, FUSED_SLICE))
        self._context = list(context)
        n_dev = len(self._context)
        self._work_load_list = work_load_list or [1] * n_dev
        assert len(self._work_load_list) == n_dev

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (reference ``module.py:104``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Checkpoint symbol + params (+ optimizer states)
        (reference ``module.py:129``)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    # ------------------------------------------------------------------
    @property
    def output_names(self):
        return self._output_names

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._exec_group.get_output_shapes()

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:      # trained values still in the executor
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Initialize parameters (reference ``module.py:173-235``): a
        given dict wins, else the initializer by name."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. init_params call ignored.", stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"

        def _seed_one(desc, arr, given):
            if given is None:
                initializer(desc, arr)
                return
            src = given.get(desc)
            if src is not None:
                if src is not arr:
                    src.copyto(arr)
                return
            if not allow_missing:
                raise RuntimeError("%s is not presented" % desc)
            if initializer is not None:
                initializer(desc, arr)

        attrs = self._symbol.attr_dict()
        for params, given in ((self._arg_params, arg_params),
                              (self._aux_params, aux_params)):
            for name, arr in sorted(params.items()):
                _seed_one(InitDesc(name, attrs.get(name, None)), arr, given)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, force_init=force_init,
                             allow_missing=allow_missing,
                             arg_params=arg_params, aux_params=aux_params)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. set_params call ignored.", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor (reference ``module.py:323-431``).  The host
        copies of the parameters live on the CPU; the executor's on the
        module's context."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module is not ported yet (it comes with "
                             "BucketingModule)")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        if label_shapes is not None and len(label_shapes):
            self._label_shapes = [x if isinstance(x, DataDesc)
                                  else DataDesc(*x) for x in label_shapes]
        else:
            self._label_shapes = None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, self.for_training,
            self.inputs_need_grad, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            host = Context("cpu")
            self._arg_params = {
                n: zeros(x[0].shape, host, x[0].dtype) for n, x in
                zip(self._param_names, self._exec_group.param_arrays)}
            self._aux_params = {
                n: zeros(x[0].shape, host, x[0].dtype) for n, x in
                zip(self._aux_names, self._exec_group.aux_arrays)}

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer (reference ``module.py:432-530``).  One
        device with a local store updates through a local updater; a
        ``dist`` store, or several devices, needs the KVStore slice and
        raises."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        _create_kvstore(kvstore, len(self._context))
        batch_size = self._data_shapes[0].shape[0]
        if isinstance(optimizer, str):
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != 1.0 / batch_size:
                self.logger.warning(
                    "optimizer.rescale_grad is %g but 1/(batch size) is %g",
                    optimizer.rescale_grad, 1.0 / batch_size)
            if not optimizer.idx2name:
                optimizer.idx2name = {i: n for i, n in
                                      enumerate(self._param_names)}
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            preload, self._preload_opt_states = self._preload_opt_states, None
            self.load_optimizer_states(preload)

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter with a gradient
        (reference ``module.py:553``)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=len(self._context))

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())
