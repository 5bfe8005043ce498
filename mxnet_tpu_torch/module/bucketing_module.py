"""BucketingModule (``mxnet_tpu/module/bucketing_module.py``): variable
sequence lengths through one child Module per bucket.

Reference ``python/mxnet/module/bucketing_module.py``.  The first bucket
bound is the default one; every other bucket binds lazily, at its first
batch, against the default bucket's module (``shared_module``), so its
executor holds the very NDArrays of the default bucket's parameters,
gradients and aux states, and the children borrow one optimizer and
updater: all buckets train one parameter set, whose momentum is one
state.  The children stay on the classic executor path (one executor a
bucket, its forward issued node by node); a CUDA graph per bucket is
later work.
"""
from __future__ import annotations

import logging

from ..base import Context, MXNetError, current_context
from .base_module import BaseModule
from .module import Module

class BucketingModule(BaseModule):
    """Drives ``sym_gen(bucket_key) -> (symbol, data_names,
    label_names)`` with one child Module per observed bucket; a batch
    selects its bucket by ``DataBatch.bucket_key``.  ``context`` defaults
    to the current context when the module is made (``gpu(0)`` unless a
    ``with mt.cpu():`` scope says otherwise), and every bucket binds
    there."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._generator = sym_gen
        self._default_key = default_bucket_key
        if context is None:
            context = Context(current_context())
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._active = None
        self._active_key = None
        self._stale_params = False
        self._grad_req = "write"
        self._monitor = None

    # -- plumbing -------------------------------------------------------
    def _generate(self, bucket_key):
        """Run sym_gen; a bare Symbol result gets default input names."""
        produced = self._generator(bucket_key)
        if isinstance(produced, tuple):
            return produced
        return produced, ("data",), ("softmax_label",)

    def _make_bucket(self, bucket_key, data_shapes, label_shapes,
                     shared_module):
        """Create and bind the child Module of one bucket, against
        ``shared_module`` (the default bucket's) after the first."""
        symbol, data_names, label_names = self._generate(bucket_key)
        child = Module(symbol, data_names, label_names, logger=self.logger,
                       context=self._context,
                       work_load_list=self._work_load_list)
        # bucket children exchange shared executors: classic path only
        child._fused_mode = "never"
        child.bind(data_shapes, label_shapes, self.for_training,
                   self.inputs_need_grad, force_rebind=False,
                   shared_module=shared_module, grad_req=self._grad_req)
        if self._monitor is not None:
            child.install_monitor(self._monitor)
        self._buckets[bucket_key] = child
        return child

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._active = None
        self._active_key = None

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._active.data_names
        return self._generate(self._default_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._active.output_names
        return self._generate(self._default_key)[0].list_outputs()

    def _bucket_attr(name):                      # noqa: N805
        def fetch(self):
            self._ensure()
            return getattr(self._active, name)
        return property(fetch)

    data_shapes = _bucket_attr("data_shapes")
    label_shapes = _bucket_attr("label_shapes")
    output_shapes = _bucket_attr("output_shapes")
    symbol = _bucket_attr("symbol")
    del _bucket_attr

    def _ensure(self, params=False, opt=False):
        assert self.binded, "bind the module first"
        if params or opt:
            assert self.params_initialized
        if opt:
            assert self.optimizer_initialized

    # -- parameters -----------------------------------------------------
    def get_params(self):
        self._ensure(params=True)
        self._active._params_dirty = self._stale_params
        snapshot = self._active.get_params()
        self._stale_params = False
        return snapshot

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._ensure()
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        self._active.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init)
        self._stale_params = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # -- lifecycle ------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket; other buckets bind lazily on their
        first batch, through :meth:`switch_bucket`."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True
        self._active = self._make_bucket(
            self._default_key, data_shapes, label_shapes, None)
        self._active_key = self._default_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding it (shared with the
        default bucket) on first use."""
        self._ensure()
        if bucket_key not in self._buckets:
            self._make_bucket(bucket_key, data_shapes, label_shapes,
                              self._buckets[self._default_key])
        self._active = self._buckets[bucket_key]
        self._active_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._ensure(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._active.init_optimizer(kvstore, optimizer, optimizer_params,
                                    force_init=force_init)
        for other in self._buckets.values():
            if other is not self._active:
                other.borrow_optimizer(self._active)
        self.optimizer_initialized = True

    # -- computation (delegated to the current bucket) ------------------
    def forward(self, data_batch, is_train=None):
        self._ensure(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._ensure(params=True)
        self._active.backward(out_grads=out_grads)

    def update(self):
        self._ensure(opt=True)
        self._stale_params = True
        self._active.update()

    def get_outputs(self, merge_multi_context=True):
        self._ensure(params=True)
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._ensure(params=True)
        assert self.inputs_need_grad
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._ensure(params=True)
        self._active.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """The monitor on every bound bucket and on each bucket bound
        later (the reference's ``switch_bucket`` installs it; the JAX
        package's reaches only the buckets bound at the call)."""
        self._ensure()
        self._monitor = mon
        for child in self._buckets.values():
            child.install_monitor(mon)
