"""Module (``mxnet_tpu/module/module.py``): the training surface over a
Symbol.

Reference ``python/mxnet/module/module.py:323-565``.  Two execution
paths, as in the JAX package:

* **fused**: forward, backward and update as one step of
  :class:`mxnet_tpu_torch.parallel.Trainer`, captured in one CUDA graph
  on the card.  ``MXTPU_MODULE_FUSED=auto`` (the default) fuses a single
  ``gpu`` context, the counterpart of the JAX package's single ``tpu``
  context, and a :class:`~mxnet_tpu_torch.parallel.Mesh` given as the
  context; ``always`` fuses any single context (the CPU tests use it);
  ``never`` keeps the classic path.  With a ``dist`` store the step
  spans every rank of the process group (the gradient sum inside it),
  and every rank starts from rank 0's parameters.
  ``forward(is_train=True)`` stages the batch, ``update()`` runs the
  step, and the outputs metrics see are the step's forward outputs.
* **classic**: one executor per context, each on its slice of the
  batch (:class:`DataParallelExecutorGroup`), gradients from their
  backward, merged through a KVStore (several contexts or a ``dist``
  store, which sums over the ranks too) and the optimizer applied per
  parameter by the store or a local updater (one device needs no
  KVStore, as in the reference).  It also takes an optimizer without a
  pure rule, with a logged warning, as the JAX package does.  Several
  contexts always take it: one process drives one device of a mesh.

A store on one device (a store object, or a ``dist_sync`` string run in
one process) keeps the fused path, as the JAX package's single-host fused
path does.  A symbol with a node whose body runs Python (a ``Custom``
op) cannot be captured: under ``auto`` it takes the classic path, and
``fused_refused`` names the nodes; under ``always`` the Trainer runs its
steps eagerly (``Trainer.uncaptured``).
"""
from __future__ import annotations

import logging
import os
import pickle
import warnings

from .. import optimizer as opt
from .. import random as _random
from ..base import Context, MXNetError, current_context
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from ..model import (_commit_file, _create_kvstore, _initialize_kvstore,
                     _update_params, _update_params_on_kvstore,
                     load_checkpoint, save_checkpoint)
from ..ndarray import zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

# the tag of a classic-path states file (the updater's blob, the
# generator's state and the optimizer's update counts)
_CLASSIC_STATES = "mxnet_tpu_torch classic states"

class Module(BaseModule):
    """Module over a Symbol (reference ``module.py:31-90``)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        # the fused path's compute dtype (e.g. "bfloat16" products with
        # float32 master weights); default from MXTPU_COMPUTE_DTYPE
        self._compute_dtype = compute_dtype or \
            os.environ.get("MXTPU_COMPUTE_DTYPE") or None
        from ..parallel.mesh import Mesh
        if context is None:
            context = current_context()
        # a mesh: the fused step over its ranks, each on its own device
        self._mesh = context if isinstance(context, Mesh) else None
        if self._mesh is not None:
            context = [current_context()]
        elif isinstance(context, Context):
            context = [context]
        elif not (isinstance(context, (list, tuple))
                  and all(isinstance(c, Context) for c in context)):
            raise MXNetError("context %r is neither a Context, a list of "
                             "them nor a mesh (parallel.Mesh)" % (context,))
        self._context = list(context)
        # fused-path policy: "auto" fuses a single gpu context, "always"
        # any single context, "never" keeps the classic executor path
        self._fused_mode = os.environ.get("MXTPU_MODULE_FUSED", "auto")
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
        self._kvstore = None
        self._update_on_kvstore = False
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        # fused path state: bind chose it, init_optimizer makes the trainer
        self._fused = False
        self._auto_fused = False
        # why bind kept the classic path on a gpu context, or None
        self.fused_refused = None
        self._trainer = None
        self._staged_batch = None
        self._fused_outputs = None

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
        (reference ``module.py:129``), each file committed atomically
        (``model._commit_file``)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params,
                        aux_params)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            _commit_file(state_name, self.save_optimizer_states)
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
        if self._exec_group is not None:
            return self._exec_group.get_output_shapes()
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names,
                        (tuple(s) for s in out_shapes)))

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:      # trained values still on the device
            self._sync_params_from_devices()
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
        if self._trainer is not None:
            # the values only: the optimizer state (momentum, Adam's
            # moments) stays, as the classic path's updater keeps it
            # through fit's epoch-end refresh (ROADMAP §C)
            self._trainer.set_params(self._arg_params, self._aux_params)
        elif self._exec_group is not None:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        # else: the fused path before init_optimizer; the trainer takes
        # the host copies when it is made

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
        if self._trainer is not None:
            self._trainer.set_params(arg_params, aux_params)
        elif self._exec_group is not None:
            self._exec_group.set_params(arg_params, aux_params)
        else:
            for params, given in ((self._arg_params, arg_params),
                                  (self._aux_params, aux_params)):
                for name, arr in (given or {}).items():
                    if name in params:
                        arr.copyto(params[name])
            self.params_initialized = True
            return
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = False
        self._trainer = None
        if self._auto_fused:
            self._mesh = None
            self._auto_fused = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind (reference ``module.py:323-431``).  The fused path only
        infers shapes and makes the host parameter copies here: its
        trainer is made by ``init_optimizer``.  The host copies of the
        parameters live on the CPU; the executor's or trainer's on the
        module's context."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None and not (
                isinstance(shared_module, Module) and shared_module.binded
                and shared_module.params_initialized
                and shared_module._exec_group is not None):
            raise MXNetError("shared_module must be a Module bound on the "
                             "classic path with its parameters initialized")
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

        # a shared bind exchanges executors: the classic path only
        fused_ok = (for_training and not inputs_need_grad and
                    shared_module is None and grad_req == "write" and
                    not self._fixed_param_names and
                    self._fused_mode != "never")
        auto = self._mesh is None and len(self._context) == 1 and (
            self._fused_mode == "always" or
            self._context[0].device_type == "gpu")
        # a node whose body runs Python (a Custom op) keeps "auto" on
        # the classic path: the fused step could not be captured
        from ..operator import uncapturable
        from ..symbol import _topo
        self.fused_refused = None
        if auto and self._fused_mode == "auto":
            self.fused_refused = uncapturable(
                _topo([e[0] for e in self._symbol._outputs]))
            auto = self.fused_refused is None
        if fused_ok and (auto or self._mesh is not None):
            self._context[0].torch_device()     # raises without the device
            self._fused = True
            self._auto_fused = auto
            self._build_param_mirrors()
            return
        self._bind_exec_group(grad_req, shared_module)
        if shared_module is not None:
            # one parameter set: the executors share the device arrays,
            # and the host copies are the shared module's own dicts
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            host = Context("cpu")
            self._arg_params = {
                n: zeros(x[0].shape, host, x[0].dtype) for n, x in
                zip(self._param_names, self._exec_group.param_arrays)}
            self._aux_params = {
                n: zeros(x[0].shape, host, x[0].dtype) for n, x in
                zip(self._aux_names, self._exec_group.aux_arrays)}

    def _bind_exec_group(self, grad_req="write", shared_module=None):
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, self.for_training,
            self.inputs_need_grad,
            shared_group=shared_module._exec_group if shared_module else None,
            logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            workload=self._work_load_list)

    def _auto_global_mesh(self):
        """The fused step's mesh under a ``dist`` store: the ``data`` axis
        over every rank of the process group, rank-major (one rank too:
        the step then issues its sum as an identity); None without a
        process group, where nothing is synchronised."""
        from ..parallel.collectives import backend
        from ..parallel.mesh import data_parallel_mesh
        if backend() is None:
            return None
        return data_parallel_mesh()

    def _build_param_mirrors(self):
        """Host (CPU) copies of the parameters at their inferred shapes,
        for the fused path, unless a checkpoint already gave them."""
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        arg_map = dict(zip(self._symbol.list_arguments(), arg_shapes))
        aux_map = dict(zip(self._aux_names, aux_shapes))
        if self._arg_params is None:
            host = Context("cpu")
            self._arg_params = {n: zeros(arg_map[n], host)
                                for n in self._param_names}
            self._aux_params = {n: zeros(aux_map[n], host)
                                for n in self._aux_names}

    def reshape(self, data_shapes, label_shapes=None):
        """New batch shapes for a bound module (reference
        ``module.py:433``).  The classic path re-binds its executor and
        carries the parameters over; the fused path's Trainer re-binds
        for the new shapes and keeps its parameters, aux and optimizer
        state where they are (a CUDA graph per batch shape)."""
        assert self.binded
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        if label_shapes is not None and len(label_shapes):
            self._label_shapes = [x if isinstance(x, DataDesc)
                                  else DataDesc(*x) for x in label_shapes]
        else:
            self._label_shapes = None
        if self._exec_group is not None:
            self._exec_group.reshape(self._data_shapes, self._label_shapes)
        elif self._trainer is not None:
            self._trainer.reshape(
                {d.name: d.shape for d in self._data_shapes},
                {d.name: d.shape for d in (self._label_shapes or [])})

    def _set_classic_states(self, blob):
        """The updater's states, the generator's state and the update
        counts, from the tagged tuple :meth:`save_optimizer_states`
        writes on the classic path."""
        try:
            loaded = pickle.loads(blob)
        except Exception as e:                      # noqa: BLE001
            raise MXNetError("optimizer state blob is truncated or "
                             "corrupt: %s: %s" % (type(e).__name__, e)) \
                from e
        if not (isinstance(loaded, tuple) and len(loaded) == 3
                and loaded[0] == _CLASSIC_STATES):
            raise MXNetError("optimizer state blob holds a %s, not the "
                             "port's classic (tag, updater states, extra) "
                             "tuple (a JAX package's states do not load "
                             "here)" % type(loaded).__name__)
        _, updater_blob, extra = loaded
        self._updater.set_states(updater_blob)
        if extra["rng"] is not None:
            _random.generator(self._context[0].torch_device()).set_state(
                extra["rng"])
        self._optimizer.num_update = extra["num_update"]
        self._optimizer._index_update_count = dict(extra["counts"])

    def install_monitor(self, mon):
        """Tap every op output of the executor (reference
        ``module.py:691-699``).  The fused path's step is one CUDA graph
        with no per-op taps: it warns, as the JAX package's does."""
        assert self.binded
        if self._exec_group is not None:
            self._exec_group.install_monitor(mon)
        else:
            self.logger.warning(
                "Monitor requires the classic executor path; the fused "
                "path has no per-op taps (the whole step is one CUDA "
                "graph). Set MXTPU_MODULE_FUSED=never to monitor.")

    def _new_trainer(self, optimizer):
        """A bound Trainer on the module's context, its params from the
        host copies."""
        from ..parallel.trainer import Trainer
        # a copy: the module's own Context may be the one a caller's
        # ``with`` has entered, and a Context holds one saved scope
        with Context(self._context[0]):
            trainer = Trainer(
                self._symbol, optimizer, data_names=self._data_names,
                label_names=self._label_names, mesh=self._mesh,
                compute_dtype=self._compute_dtype)
        trainer.bind(
            data_shapes={d.name: d.shape for d in self._data_shapes},
            label_shapes={d.name: d.shape
                          for d in (self._label_shapes or [])})
        trainer.init_params(arg_params=self._arg_params,
                            aux_params=self._aux_params, force_init=True)
        return trainer

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer and the KVStore (reference
        ``module.py:432-530``).  A ``dist`` string becomes its store first,
        so the default ``rescale_grad`` covers the global batch (the local
        batch times ``num_workers``).  The fused path makes its Trainer
        here: under a ``dist`` store over a process group its mesh spans
        every rank (``_auto_global_mesh``), and every rank starts from
        rank 0's parameters; an optimizer without a pure rule falls back,
        with a warning, to the classic path.  There a store owns the
        update when ``_create_kvstore`` says so, else a local updater
        runs."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        from ..kvstore import KVStore, create as kv_create
        if isinstance(kvstore, str) and "dist" in kvstore:
            kvstore = kv_create(kvstore)
        kv = kvstore if isinstance(kvstore, KVStore) else None
        batch_size = self._data_shapes[0].shape[0]
        if kv is not None and "dist" in kv.type and "_async" not in kv.type:
            batch_size *= kv.num_workers
        named_here = isinstance(optimizer, str) or not optimizer.idx2name
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
        if self._fused:
            from ..parallel.optim import _supports_fusion
            if kv is not None and "dist" in kv.type and self._auto_fused:
                self._mesh = self._auto_global_mesh()
            if _supports_fusion(optimizer):
                if self._mesh is not None and self._mesh.size > 1:
                    # replicated parameters start alike: rank 0's win
                    # (kvstore_dist.h:63-80)
                    from ..parallel.collectives import broadcast_from_rank0
                    for params in (self._arg_params, self._aux_params):
                        for arr in params.values():
                            arr._set_data(broadcast_from_rank0(arr.data))
                self._trainer = self._new_trainer(optimizer)
                self._kvstore, self._update_on_kvstore = None, False
                self._finish_optimizer_init()
                return
            # an optimizer without a pure fused-step rule (SGLD,
            # user-defined subclasses) trains on the classic path
            self.logger.warning("optimizer %s has no fused-step rule; using "
                                "the classic executor path"
                                % type(optimizer).__name__)
            self._fused = False
            self._trainer = None
            self._bind_exec_group()
            self._exec_group.set_params(self._arg_params, self._aux_params)
        self._kvstore, self._update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        n_dev = len(self._context)
        if named_here and not self._update_on_kvstore and n_dev > 1:
            # a local updater keys device k's copy of parameter i as
            # i * n_dev + k (model._update_params): name those keys, so
            # lr_mult, wd_mult and the bias/gamma wd default find them
            # (reference module.py:484-490)
            optimizer.idx2name = {i * n_dev + k: n for i, n in
                                  enumerate(self._param_names)
                                  for k in range(n_dev)}
        if self._kvstore:
            _initialize_kvstore(self._kvstore, self._exec_group.param_arrays,
                                self._arg_params, self._param_names,
                                self._update_on_kvstore)
        if self._update_on_kvstore:
            self._updater = None
            self._kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self._finish_optimizer_init()

    def _finish_optimizer_init(self):
        """Mark ready and load any optimizer state a resume queued."""
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            preload, self._preload_opt_states = self._preload_opt_states, None
            self.load_optimizer_states(preload)

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer, store and updater, so their
        state (momentum) is one state (reference ``module.py:531``)."""
        assert shared_module.optimizer_initialized
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._fused:
            if is_train is None:
                is_train = self.for_training
            batch = self._fused_batch_dict(data_batch)
            if is_train:
                self._staged_batch = batch
                self._fused_outputs = None
            else:
                self._ensure_trainer()
                self._fused_outputs = self._trainer.forward(batch)
            return
        self._exec_group.forward(data_batch, is_train)

    def _ensure_trainer(self):
        """A fused-path forward before init_optimizer (``score`` on a
        freshly bound module): a trainer with a placeholder optimizer,
        which init_optimizer replaces."""
        if self._trainer is None:
            self._trainer = self._new_trainer(opt.SGD())

    def _fused_batch_dict(self, data_batch):
        """The batch's arrays by name, in the order of the shapes the
        module was bound with (the iterator's ``provide_data`` and
        ``provide_label``), which a batch's arrays follow, as the classic
        path's executor group reads them: a dict-fed ``NDArrayIter``
        sorts its inputs by name, whatever order ``data_names`` gives."""
        batch = dict(zip([d.name for d in self._data_shapes],
                         data_batch.data))
        if data_batch.label is not None:
            batch.update(zip([d.name for d in self._label_shapes or []],
                             data_batch.label))
        return batch

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused:
            assert out_grads is None, \
                "the fused path computes gradients inside its step"
            return
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer (reference ``module.py:553``): on the fused
        path, the whole step."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._trainer is not None:
            assert self._staged_batch is not None, \
                "call forward(is_train=True) before update() on the fused path"
            self._fused_outputs = self._trainer.step(self._staged_batch)
            self._staged_batch = None
            return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused:
            if self._fused_outputs is None and self._staged_batch is not None:
                # outputs read between forward(is_train=True) and update():
                # a training-mode forward without the update
                self._ensure_trainer()
                self._fused_outputs = self._trainer.forward_train(
                    self._staged_batch)
            assert self._fused_outputs is not None, \
                "no outputs yet: run forward() or update()"
            return self._fused_outputs
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused:
            if self._fused_outputs is None and self._staged_batch is not None:
                # the metric before update(): a training-mode forward (the
                # fit loop's update-then-metric order avoids this cost)
                self.get_outputs()
            if self._fused_outputs is not None:
                eval_metric.update(labels, self._fused_outputs)
            return
        self._exec_group.update_metric(eval_metric, labels)

    # ------------------------------------------------------------------
    def _sync_params_from_devices(self):
        """Copy the trained values into the host copies."""
        if self._trainer is not None:
            for store, host in ((self._trainer.params, self._arg_params),
                                (self._trainer.aux, self._aux_params)):
                for n, v in store.items():
                    host[n]._set_data(v)
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    @property
    def sentinel_skips(self):
        """The fused step's sentinel skip count (0 on the classic path,
        which has no finiteness watch)."""
        if self._trainer is not None:
            return self._trainer.sentinel_skips
        return 0

    def state_fingerprint(self):
        """The training state's integrity record for a checkpoint's
        manifest (``integrity.py``).  The fused path: the fingerprint
        the device computes over the params, aux states and optimizer
        state.  The classic path: a host hash of the parameter copies
        (``arg:``/``aux:`` only), as in the JAX package."""
        if self._trainer is not None:
            return self._trainer.state_fingerprint()
        from .. import integrity
        assert self.binded and self.params_initialized
        arg_params, aux_params = self.get_params()
        named = integrity.named_state_leaves(
            {n: v.asnumpy() for n, v in arg_params.items()},
            {n: v.asnumpy() for n, v in aux_params.items()})
        global_fp, leaves = integrity.host_fingerprint(named)
        return integrity.manifest_record(global_fp, leaves, mode="host")

    def save_optimizer_states(self, fname):
        """The optimizer state: the fused Trainer's blob, or on the
        classic path the updater's states with the device generator's
        state and the optimizer's update counts beside them (so a resumed
        run draws the Dropout masks, and steps with the bias corrections
        and lr schedule, that the uninterrupted one would)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        if self._trainer is not None:
            blob = self._trainer.get_opt_states()
        else:
            rng = _random.generator(self._context[0].torch_device())
            o = self._optimizer
            blob = pickle.dumps((_CLASSIC_STATES, self._updater.get_states(),
                                 {"rng": rng.get_state(),
                                  "num_update": o.num_update,
                                  "counts": dict(o._index_update_count)}))
        with open(fname, "wb") as fout:
            fout.write(blob)

    def load_optimizer_states(self, fname):
        """Restore a state file of the port's (a JAX package's does not
        load here: it raises, naming the file)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            blob = fin.read()
        try:
            if self._trainer is None:
                self._set_classic_states(blob)
            else:
                self._trainer.set_opt_states(blob)
        except MXNetError as e:
            raise MXNetError("optimizer states file %r: %s"
                             % (fname, e)) from e
