"""Model-level helpers (``mxnet_tpu/model.py``): the KVStore decision,
the store-side and local parameter updates, the checkpoint format, and
the legacy :class:`FeedForward` API.

Checkpoints use the reference's on-disk contract (``model.py:319-375``):
``prefix-symbol.json`` + ``prefix-%04d.params`` with ``arg:``/``aux:``
key prefixes, so a checkpoint saved by either package loads in the
other.  Every file is committed atomically (write to ``<path>.tmp``,
fsync, rename, fsync the directory), as the JAX package's are, so a
crash mid-save leaves the previous version visible and a ``.tmp`` that
the resume scan sweeps (``resilience.py``).
"""
from __future__ import annotations

import glob
import logging
import os
import re
from collections import namedtuple

import numpy as np

from . import faults as _faults
from . import io
from . import ndarray as nd
from . import optimizer as opt
from . import symbol as sym
from .base import Context, MXNetError, current_context
from .initializer import Uniform

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "FeedForward", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store, update_on_kvstore)`` (reference ``model.py:40-68``).  One
    device with a local store needs none; several devices, a ``dist``
    string or a store object give a store, which owns the update except
    for a ``local`` store over small parameters (a local updater then
    runs on each device's copy of the merged gradients)."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store with the host values, one key per parameter index
    (reference ``model.py:70-86``); when the store owns the update, pull
    them straight back onto every device copy."""
    for idx, (name, dev_copies) in enumerate(zip(param_names,
                                                 param_arrays)):
        kvstore.init(idx, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(idx, dev_copies, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Store-side update (reference ``model.py:88-99``): push the step's
    gradients, pull back the updated weights.  Frozen parameters
    (gradient slot None) never touch the store."""
    for idx, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is None:
            continue
        kvstore.push(idx, grads, priority=-idx)
        kvstore.pull(idx, weights, priority=-idx)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Local-updater path (reference ``model.py:99-116``): with a store,
    push then pull leaves the summed gradients in the gradient arrays;
    then the updater runs on each device copy under the reference's
    ``index * num_device + device`` state keys.  Frozen parameters
    (gradient slot None) are skipped."""
    for idx, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is None:
            continue
        if kvstore:
            kvstore.push(idx, grads, priority=-idx)
            kvstore.pull(idx, grads, priority=-idx)
        for dev, (w, g) in enumerate(zip(weights, grads)):
            updater(idx * num_device + dev, g, w)


_atomic_saves = 0

# what ``save_checkpoint(async_write=True)`` needs
ENGINE_SLICE = ("async_write=True writes through the dependency engine, "
                "which waits for the port's engine.py (ROADMAP queue A, "
                "item 9)")


def _commit_file(path, write_fn, crash_site=None, **crash_ctx):
    """``write_fn(tmp_path)``, fsync the tmp file, rename it into place,
    then fsync the parent directory where the filesystem allows it.

    The rename is atomic against a process crash; the data fsync before
    it keeps a kernel crash from renaming a file whose bytes never
    landed, and the directory fsync persists the rename.  ``crash_site``
    arms fault injection between the flush and the rename, the window
    that leaks ``*.tmp`` and leaves the previous version visible."""
    tmp = path + ".tmp"
    write_fn(tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    if crash_site is not None:
        _faults.maybe_crash(crash_site, **crash_ctx)
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _atomic_save(path, save_dict):
    """Commit an NDArray dict atomically (``crash@ckpt_write`` fires
    between write and rename; ``save=`` is this process's count of such
    saves, 1-based)."""
    global _atomic_saves
    _atomic_saves += 1
    _commit_file(path, lambda tmp: nd.save(tmp, save_dict),
                 crash_site="ckpt_write", save=_atomic_saves)


def _sweep_stale_tmp(prefix):
    """Delete the ``*.tmp`` files of saves that crashed between write and
    rename; returns the removed paths."""
    removed = []
    for path in glob.glob(glob.escape(prefix) + "*.tmp"):
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    if removed:
        logging.info("removed %d stale checkpoint tmp file(s): %s",
                     len(removed), ", ".join(removed))
    return removed


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    async_write=False):
    """Checkpoint to ``prefix-symbol.json`` + ``prefix-%04d.params``
    (reference ``model.py:319-341``), each file committed atomically: the
    symbol JSON is shared by every epoch under the prefix, so a torn
    rewrite would break every earlier checkpoint's load."""
    if async_write:
        raise MXNetError(ENGINE_SLICE)
    if symbol is not None:
        _commit_file("%s-symbol.json" % prefix, symbol.save)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    _atomic_save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def latest_checkpoint(prefix):
    """The newest epoch saved under ``prefix`` (``prefix-NNNN.params``),
    or None."""
    newest = None
    for path in glob.glob(glob.escape(prefix) +
                          "-[0-9][0-9][0-9][0-9].params"):
        m = re.search(r"-(\d{4})\.params$", path)
        if m:
            newest = max(newest or 0, int(m.group(1)))
    return newest


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays
    on the CPU (reference ``model.py:342-375``).  A truncated or corrupt
    params file raises :class:`MXNetError` naming that file."""
    symbol = sym.load("%s-symbol.json" % prefix)
    param_file = "%s-%04d.params" % (prefix, epoch)
    try:
        save_dict = nd.load(param_file)
    except MXNetError as e:
        raise MXNetError("checkpoint params file %r is truncated or "
                         "corrupt: %s" % (param_file, e)) from e
    except Exception as e:                          # noqa: BLE001
        raise MXNetError("checkpoint params file %r is truncated or "
                         "corrupt: %s: %s"
                         % (param_file, type(e).__name__, e)) from e
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward(object):
    """The legacy model API (reference ``model.py:377-936``), a thin
    adapter over :class:`~mxnet_tpu_torch.module.Module`."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [Context(current_context())]
        elif not isinstance(ctx, (list, tuple)):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _get_module(self, data, label_name="softmax_label"):
        from .module import Module
        args = self.symbol.list_arguments()
        label_names = [label_name] if label_name in args else \
            [n for n in args if n.endswith("_label")]
        return Module(self.symbol,
                      data_names=[d.name if isinstance(d, io.DataDesc)
                                  else d[0] for d in data.provide_data],
                      label_names=label_names or None, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._prepare_data(X, y)
        self._module = self._get_module(data)
        optimizer = self.optimizer
        if isinstance(optimizer, str):
            optimizer = opt.create(optimizer,
                                   rescale_grad=(1.0 / data.batch_size),
                                   **self.kwargs)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=optimizer,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _prepare_data(self, X, y=None):
        """An iterator over ``X`` (and ``y``), on the model's context."""
        if isinstance(X, io.DataIter):
            return X
        X = np.asarray(X)
        if y is not None:
            y = np.asarray(y)
        batch_size = min(self.numpy_batch_size, X.shape[0])
        # a copy: a Context holds one saved scope
        with Context(self.ctx[0]):
            return io.NDArrayIter(X, y, batch_size=batch_size,
                                  shuffle=False)

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._prepare_data(X)
        if self._module is None:
            self._module = self._get_module(data)
            self._module.bind(data_shapes=data.provide_data,
                              label_shapes=None, for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {})
        outputs = self._module.predict(data, num_batch=num_batch,
                                       reset=reset)
        if isinstance(outputs, list):
            return [o.asnumpy() for o in outputs]
        return outputs.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._prepare_data(X)
        res = self._module.score(data, eval_metric, num_batch=num_batch,
                                 batch_end_callback=batch_end_callback,
                                 reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix,
                        self.num_epoch if epoch is None else epoch,
                        self.symbol, self.arg_params, self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, args, auxs = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=args,
                           aux_params=auxs, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        kwargs.update(num_epoch=num_epoch, epoch_size=epoch_size,
                      optimizer=optimizer, initializer=initializer)
        model = FeedForward(symbol, ctx=ctx, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
