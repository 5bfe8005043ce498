"""SequentialModule (``mxnet_tpu/module/sequential_module.py``): modules
run head to tail as one module.

Reference ``python/mxnet/module/sequential_module.py``
(``add(module, take_labels=..., auto_wiring=...)``, the META_*
constants).  The chain is a list of ``_Stage`` records, and the label
routing is fixed at ``add``.  Stages hand each other activations and
gradients as NDArrays on their context, so a Module in a chain runs its
classic executor path: the fused step is for a Module on its own.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

_Stage = namedtuple("_Stage", ["module", "take_labels", "auto_wiring"])


class SequentialModule(BaseModule):
    """A container that runs its modules in sequence."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None

    def add(self, module, **meta):
        """Append ``module``; ``take_labels=True`` routes the labels to
        it, ``auto_wiring=True`` renames the previous stage's outputs to
        its data names (reference ``sequential_module.py:48``)."""
        unknown = set(meta) - {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        if unknown:
            raise ValueError("unknown meta keys %s" % sorted(unknown))
        # stages exchange activations and gradients: the classic path
        if hasattr(module, "_fused_mode"):
            module._fused_mode = "never"
        self._stages.append(_Stage(module,
                                   bool(meta.get(self.META_TAKE_LABELS)),
                                   bool(meta.get(self.META_AUTO_WIRING))))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- introspection: the ends of the chain ---------------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # -- parameters -----------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for stage in self._stages:
            a, x = stage.module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "bind the chain before init_params"
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        owner = {}
        for idx, stage in enumerate(self._stages):
            stage.module.init_params(initializer=initializer,
                                     arg_params=arg_params,
                                     aux_params=aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
            a, x = stage.module.get_params()
            for name in list(a) + list(x):
                if name in owner:
                    raise ValueError(
                        "parameter %r defined by both stage %d (%s) and "
                        "stage %d (%s)" % (name, owner[name],
                                           type(self._stages[owner[name]]
                                                .module).__name__,
                                           idx, type(stage.module).__name__))
                owner[name] = idx
        self.params_initialized = True

    # -- bind: shapes threaded through the chain ------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind every stage in order, each on the previous stage's output
        shapes (reference ``sequential_module.py:153``)."""
        if self.binded and not force_rebind:
            self.logger.warning("SequentialModule already bound; skipping")
            return
        if shared_module is not None:
            raise ValueError("shared_module is not supported on chains")
        if not self._stages:
            raise ValueError("cannot bind an empty SequentialModule")
        if inputs_need_grad:
            assert for_training
        feed = data_shapes
        for idx, stage in enumerate(self._stages):
            if stage.auto_wiring:
                names = stage.module.data_names
                assert len(names) == len(feed)
                feed = [DataDesc(n, (d.shape if isinstance(d, DataDesc)
                                     else d[1]))
                        for n, d in zip(names, feed)]
            stage.module.bind(
                data_shapes=feed,
                label_shapes=label_shapes if stage.take_labels else None,
                for_training=for_training,
                # an interior stage needs its input gradients to carry
                # the backward on
                inputs_need_grad=bool(inputs_need_grad or
                                      (for_training and idx > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            feed = [DataDesc(n, s) for n, s in stage.module.output_shapes]
        any_labels = any(s.take_labels for s in self._stages)
        self._label_shapes = label_shapes if any_labels else None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for stage in self._stages:
            stage.module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                        optimizer_params=optimizer_params,
                                        force_init=force_init)
        self.optimizer_initialized = True

    # -- computation ----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for idx, stage in enumerate(self._stages):
            stage.module.forward(batch, is_train=is_train)
            nxt = idx + 1
            if nxt == len(self._stages):
                break
            batch = DataBatch(
                data=stage.module.get_outputs(),
                label=(data_batch.label
                       if self._stages[nxt].take_labels else None),
                pad=data_batch.pad, index=data_batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for idx in range(len(self._stages) - 1, -1, -1):
            self._stages[idx].module.backward(out_grads=out_grads)
            if idx:
                out_grads = self._stages[idx].module.get_input_grads()

    def update(self):
        assert self.optimizer_initialized
        for stage in self._stages:
            stage.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage in self._stages:
            if stage.take_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages:
            stage.module.install_monitor(mon)
