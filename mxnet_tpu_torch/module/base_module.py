"""BaseModule (``mxnet_tpu/module/base_module.py``): the train, evaluate
and predict drivers over a subclass's computation primitives.

The reference's surface (``python/mxnet/module/base_module.py``):
``fit``, ``score``, ``predict``, ``iter_predict``, ``forward_backward``,
the bind -> init_params -> init_optimizer lifecycle and ``arg:``/``aux:``
parameter files.  On the fused path ``fit`` stages each batch's upload
ahead of its step (:class:`~mxnet_tpu_torch.io.DeviceUploadIter`), as the
JAX package's does.  ``fit`` takes a ``monitor``, and checkpoints with
resume (``checkpoint``, ``checkpoint_period``, ``resume``; see
``resilience.py``); each batch fetch is retried on a transient
``OSError``.  ``elastic`` (an
:class:`~mxnet_tpu_torch.elastic.ElasticCoordinator`) guards every batch
with the step barrier, and an
:class:`~mxnet_tpu_torch.integrity.IntegrityError` of the fused step rolls
the run back to the newest verified checkpoint, as in the JAX package.

At an epoch's end ``fit`` copies the trained values to the host and
writes them back (``set_params``), as the JAX package's does; the
optimizer state stays on both paths, where the JAX package's fused path
re-creates it (ROADMAP §C).
"""
from __future__ import annotations

import logging
import os
import time

from .. import metric as metric_mod
from .. import ndarray
from ..model import BatchEndParam
from .. import obs as _obs
from ..base import MXNetError
from ..ndarray import NDArray


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _invoke(callbacks, param):
    for cb in _as_list(callbacks):
        cb(param)


def _check_input_names(symbol, names, typename, throw):
    """Every requested input must be an argument of the symbol."""
    args = symbol.list_arguments()
    missing = [n for n in names if n not in args]
    if not missing:
        return
    param_suffixes = ("_weight", "_bias", "_gamma", "_beta")
    suggestions = [a for a in args if not a.endswith(param_suffixes)]
    for name in missing:
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). "
               "Did you mean one of:\n\t%s" % (
                   typename, str(names), name, "\n\t".join(suggestions)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule(object):
    """Abstract module: subclasses implement the computation primitives
    (forward/backward/update/...) and inherit the drivers."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = self.params_initialized = False
        self.for_training = self.inputs_need_grad = False
        self.optimizer_initialized = False
        self._symbol = None

    # ==================================================================
    # drivers
    def forward_backward(self, data_batch):
        """Forward then backward in one call."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _evaluation_pass(self, eval_data, num_batch, reset):
        """Forward (``is_train=False``) over an iterator, yielding
        ``(nbatch, batch, outputs without the pad rows)``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                return
            self.forward(batch, is_train=False)
            keep = None if not batch.pad else -batch.pad
            yield nbatch, batch, [NDArray(o.data[:keep])
                                  for o in self.get_outputs()]

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate ``eval_metric`` over an iterator."""
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                _invoke(batch_end_callback,
                        BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals()))
            seen = nbatch + 1
        if score_end_callback:
            _invoke(score_end_callback,
                    BatchEndParam(epoch=epoch, nbatch=seen,
                                  eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` per evaluation batch."""
        for nbatch, batch, outputs in self._evaluation_pass(
                eval_data, num_batch, reset):
            yield outputs, nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Collect predictions; with ``merge_batches`` the per-batch
        outputs are concatenated (and a single output unwrapped)."""
        collected = [outputs for _, _, outputs in self._evaluation_pass(
            eval_data, num_batch, reset)]
        if not collected or not merge_batches:
            return collected
        width = len(collected[0])
        if any(len(outs) != width for outs in collected):
            raise AssertionError(
                "Cannot merge batches: the number of outputs varies "
                "across mini-batches. Maybe bucketing is used?")
        merged = [ndarray.concatenate([outs[i] for outs in collected])
                  for i in range(width)]
        if width == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None, checkpoint_period=1,
            resume=False, elastic=None):
        """Bind, initialize, then train for epochs of
        forward_backward / update / update_metric with callbacks
        (reference ``base_module.py:143``).

        ``checkpoint`` (a prefix or a
        :class:`~mxnet_tpu_torch.resilience.CheckpointManager`) saves a
        CRC-manifested checkpoint (params, optimizer state, the step)
        every ``checkpoint_period`` epochs; with ``resume=True`` a killed
        run started again with the same arguments continues from the
        newest intact checkpoint and, with a deterministic iterator,
        reproduces the uninterrupted run bit for bit.  ``monitor`` (a
        :class:`~mxnet_tpu_torch.monitor.Monitor`) is installed after the
        bind and ticks around each step.

        ``elastic`` (an :class:`~mxnet_tpu_torch.elastic.ElasticCoordinator`)
        runs its guard before every batch: a dead peer raises
        :class:`~mxnet_tpu_torch.elastic.ElasticShrink` at the next batch
        boundary instead of hanging the step's collectives; the caller
        exits with ``elastic.SHRINK_EXIT_CODE`` and the launcher starts
        the shrunk world, which resumes through ``checkpoint``/``resume``.
        An :class:`~mxnet_tpu_torch.integrity.IntegrityError` of the fused
        step rolls back to the newest checkpoint that re-hashes to its
        manifest's fingerprint and trains on from there, at most
        ``MXTPU_INTEGRITY_MAX_ROLLBACKS`` (3) times without progress; a
        blamed replica is quarantined through ``elastic``."""
        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        ckpt_mgr = None
        if checkpoint is not None:
            from .. import resilience
            ckpt_mgr = checkpoint \
                if isinstance(checkpoint, resilience.CheckpointManager) \
                else resilience.CheckpointManager(checkpoint)
        resumed = None
        if resume:
            assert ckpt_mgr is not None, \
                "fit(resume=True) needs checkpoint=<prefix or manager>"
            resumed = ckpt_mgr.latest()
            if resumed is not None:
                _, arg_params, aux_params = resumed.load_params()
                begin_epoch = resumed.epoch
                self.logger.info(
                    "auto-resume: continuing from checkpoint epoch %d "
                    "(step %s)", resumed.epoch, resumed.step)
        self.bind(train_data.provide_data, train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, force_init=force_init,
                         allow_missing=allow_missing,
                         arg_params=arg_params, aux_params=aux_params)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resumed is not None and resumed.states_path:
            # the optimizer state (momentum; the fused trainer's update
            # count, sentinel and random state) lands in what
            # init_optimizer built
            self.load_optimizer_states(resumed.states_path)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        # the fused path: stage batch N+1's upload while step N computes
        staged = self._maybe_overlap_uploads(train_data)
        wrapped = staged is not train_data
        from .. import envknobs
        max_rollbacks = envknobs.get_int("MXTPU_INTEGRITY_MAX_ROLLBACKS", 3)
        self._wire_blame(elastic)
        if elastic is not None and \
                os.environ.get("MXTPU_COMM_PARITY", "1") != "0":
            # the port traces no comm plan yet (ROADMAP item 10): the
            # sentinel digest, so the peers' parity check logs the pair
            # as unverified instead of waiting on a missing stamp
            from ..elastic import COMM_PLAN_UNTRACED
            try:
                elastic.publish_comm_plan([], digest=COMM_PLAN_UNTRACED)
            except Exception as e:                  # noqa: BLE001
                self.logger.warning("comm-plan stamp not published: %s", e)
        try:
            self._fit_epochs(staged, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch, num_epoch,
                             monitor, ckpt_mgr, checkpoint_period, elastic,
                             max_rollbacks)
        finally:
            if wrapped:
                staged._shutdown_worker()

    def _wire_blame(self, elastic):
        """The fused trainer's blame callback for this fit: quarantine the
        blamed replica through ``elastic`` (blame can resolve after the
        rollback, when the replay's agreeing check exonerates the honest
        replica).  Rewired on every fit, whose coordinator may differ; a
        callback the user installed stays."""
        trainer = getattr(self, "_trainer", None)
        if trainer is None or not (
                trainer.on_integrity_blame is None
                or getattr(trainer.on_integrity_blame, "_fit_wired", False)):
            return
        if elastic is None:
            trainer.on_integrity_blame = None
            return

        def _blame_cb(record, _elastic=elastic):
            self._quarantine_blamed(record, _elastic)
        _blame_cb._fit_wired = True
        trainer.on_integrity_blame = _blame_cb

    def _quarantine_blamed(self, record, elastic):
        """Shrink every blamed replica's process out of the elastic
        membership: the outvoted rank is alive and heartbeating, and
        policy, not a lapsed heartbeat, removes it.  A rank of the port's
        data mesh is one process, so a replica's index is its rank."""
        for rank in sorted({int(r) for r in record.get("blamed") or []}):
            try:
                elastic.quarantine(rank)
            except Exception as e:                  # noqa: BLE001
                self.logger.warning(
                    "integrity: quarantine of blamed rank %s failed: %s",
                    rank, e)

    def _integrity_rollback(self, err, ckpt_mgr, elastic, rollbacks,
                            max_rollbacks):
        """One round of the rollback to the newest verified checkpoint;
        returns the epoch the fit loop enters again.  Raises MXNetError
        when nothing trustworthy is left to restore or the cap of
        consecutive divergences is reached."""
        record = getattr(err, "record", None) or {}
        if rollbacks > max_rollbacks:
            raise MXNetError(
                "integrity: %d consecutive divergences without verified "
                "progress (MXTPU_INTEGRITY_MAX_ROLLBACKS=%d) — the "
                "corruption recurs faster than checkpoints verify; "
                "refusing to rollback-loop. Last divergence: %s"
                % (rollbacks, max_rollbacks, err)) from err
        cb = getattr(getattr(self, "_trainer", None),
                     "on_integrity_blame", None)
        if elastic is not None and record.get("blamed") and \
                not getattr(cb, "_fit_wired", False):
            # the fit-wired callback already quarantined a record whose
            # blame the trainer resolved at detection
            self._quarantine_blamed(record, elastic)
        if ckpt_mgr is None:
            raise MXNetError(
                "integrity divergence at update %s but fit() has no "
                "checkpoint line to roll back to — pass "
                "checkpoint=<prefix> to enable recovery: %s"
                % (record.get("step"), err)) from err
        ck = ckpt_mgr.latest_verified()
        if ck is None:
            raise MXNetError(
                "integrity divergence at update %s and NO checkpoint "
                "re-hashes to its manifest fingerprint — the corruption "
                "predates the whole retained checkpoint line: %s"
                % (record.get("step"), err)) from err
        self.logger.warning(
            "integrity: divergence at update %s (mode=%s, blamed=%s) — "
            "rolling back to verified checkpoint epoch %d (step %s) and "
            "re-stepping [rollback %d/%d]",
            record.get("step"), record.get("mode"), record.get("blamed"),
            ck.epoch, ck.step, rollbacks, max_rollbacks)
        _obs.counter("integrity.rollbacks").inc()
        _, arg_params, aux_params = ck.load_params()
        self.set_params(arg_params, aux_params)
        if ck.states_path and getattr(self, "optimizer_initialized",
                                      False):
            self.load_optimizer_states(ck.states_path)
        return ck.epoch

    def _maybe_overlap_uploads(self, train_data):
        """``train_data`` wrapped in a
        :class:`~mxnet_tpu_torch.io.DeviceUploadIter` on the module's
        context when the fused Trainer consumes it, so each batch's upload
        overlaps the previous step (``mxnet_tpu/module/base_module.py:424``).
        ``MXTPU_UPLOAD_OVERLAP=0`` turns it off, ``=1`` on; by default it
        is on where the host has more than one core.
        ``MXTPU_UPLOAD_DEPTH`` (default 2) bounds the staged batches,
        ``MXTPU_UPLOAD_CHUNKS`` (default 1) splits each host batch's
        upload into row chunks."""
        import os
        from .. import envknobs
        from ..io import DeviceUploadIter
        knob = os.environ.get("MXTPU_UPLOAD_OVERLAP", "")
        enabled = knob == "1" or (knob != "0"
                                  and (os.cpu_count() or 1) > 1)
        if (getattr(self, "_trainer", None) is None or not enabled
                or isinstance(train_data, DeviceUploadIter)):
            return train_data
        return DeviceUploadIter(
            train_data, device=self._context[0],
            depth=envknobs.get_int("MXTPU_UPLOAD_DEPTH", 2),
            chunks=envknobs.get_int("MXTPU_UPLOAD_CHUNKS", 1))

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback, batch_end_callback,
                    eval_end_callback, eval_batch_end_callback, begin_epoch,
                    num_epoch, monitor, ckpt_mgr, checkpoint_period,
                    elastic=None, max_rollbacks=3):
        from ..integrity import IntegrityError
        rollbacks = 0
        epoch = begin_epoch
        while epoch < num_epoch:
            try:
                elapsed = self._train_epoch(epoch, train_data, eval_metric,
                                            batch_end_callback, monitor,
                                            elastic)
            except IntegrityError as err:
                rollbacks += 1
                epoch = self._integrity_rollback(
                    err, ckpt_mgr, elastic, rollbacks, max_rollbacks)
                train_data.reset()
                continue
            rollbacks = 0           # verified forward progress
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, elapsed)
            # pull the trained values off the device and refresh mirrors
            arg_snap, aux_snap = self.get_params()
            self.set_params(arg_snap, aux_snap)
            trainer = getattr(self, "_trainer", None)
            if trainer is not None and trainer.sentinel != "off":
                skips = trainer.sentinel_skips
                if skips:
                    self.logger.warning(
                        "Epoch[%d] sentinel skipped %d non-finite "
                        "step(s) so far", epoch, skips)
            if ckpt_mgr is not None and \
                    (epoch + 1) % checkpoint_period == 0:
                with _obs.span("fit.checkpoint", corr="e%d" % (epoch + 1),
                               parent=None, attrs={"epoch": epoch + 1}):
                    ckpt_mgr.save(self, epoch + 1, arg_params=arg_snap,
                                  aux_params=aux_snap)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_snap, aux_snap)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()
            epoch += 1

    def _train_epoch(self, epoch, train_data, eval_metric,
                     batch_end_callback, monitor=None, elastic=None):
        """One pass over ``train_data``; returns the wall time
        (reference ``base_module.py:475``).  Each fetch rides
        :func:`~mxnet_tpu_torch.resilience.retry_io`: a transient
        ``OSError`` of the input pipeline (an injected ``io_error``
        too) is retried with backoff; a persistent one propagates.  With
        ``elastic`` the coordinator's guard runs before every step: no
        rank enters the step until every member has committed to it, and
        a lapsed member surfaces here as ``ElasticShrink``."""
        from ..resilience import retry_io
        eval_metric.reset()
        tic = time.time()
        data_iter = iter(train_data)
        trainer = getattr(self, "_trainer", None)
        nbatch = 0
        while True:
            try:
                data_batch = retry_io(lambda: next(data_iter),
                                      what="train batch fetch",
                                      logger=self.logger)
            except StopIteration:
                break
            if elastic is not None:
                elastic.guard(trainer.num_update + 1
                              if trainer is not None else None)
            if monitor is not None:
                monitor.tic()
            self.forward_backward(data_batch)
            self.update()
            self.update_metric(eval_metric, data_batch.label)
            if monitor is not None:
                monitor.toc_print()
            if batch_end_callback is not None:
                _invoke(batch_end_callback,
                        BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals()))
            nbatch += 1
        return time.time() - tic

    # ==================================================================
    # symbol / params
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, force_init=force_init,
                         allow_missing=allow_missing,
                         arg_params=arg_params, aux_params=aux_params)

    def save_params(self, fname):
        """Write params with the reference's ``arg:``/``aux:`` prefixes."""
        arg_params, aux_params = self.get_params()
        blob = {"arg:" + k: v for k, v in arg_params.items()}
        blob.update(("aux:" + k, v) for k, v in aux_params.items())
        ndarray.save(fname, blob)

    def load_params(self, fname):
        """Inverse of :meth:`save_params`."""
        arg_params, aux_params = {}, {}
        bins = {"arg": arg_params, "aux": aux_params}
        for key, value in ndarray.load(fname).items():
            kind, _, name = key.partition(":")
            if kind not in bins or not name:
                raise ValueError("Invalid param file " + fname)
            bins[kind][name] = value
        self.set_params(arg_params, aux_params)

    # ==================================================================
    # computation primitives (subclass responsibility)
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def _abstract_property(self):
        raise NotImplementedError()

    data_names = property(_abstract_property)
    output_names = property(_abstract_property)
    data_shapes = property(_abstract_property)
    label_shapes = property(_abstract_property)
    output_shapes = property(_abstract_property)

    def install_monitor(self, mon):
        raise NotImplementedError()
