"""Training callbacks (``mxnet_tpu/callback.py``): epoch-end
checkpointing and batch-end logging.

API parity with the reference's ``python/mxnet/callback.py`` (Speedometer,
``do_checkpoint``/``module_checkpoint``, ProgressBar, metric loggers),
built around two small primitives: ``_periodic`` (the modulo trigger of
every per-epoch and per-batch hook) and ``_RateMeter`` (a sliding
time/count window; device work is asynchronous, so its ``time.time()``
deltas span whole windows of batches).
"""
from __future__ import annotations

import logging
import sys
import time


def _periodic(period):
    """Return ``hit(i)`` that fires on every ``period``-th 1-based tick."""
    period = max(1, int(period))
    return lambda i: (i + 1) % period == 0


def _emit_metric(metric, fmt, *head, reset=False):
    """Log each (name, value) pair of ``metric`` through ``fmt``."""
    if metric is None:
        return False
    pairs = metric.get_name_value()
    if reset:
        metric.reset()
    for name, value in pairs:
        logging.info(fmt, *(head + (name, value)))
    return bool(pairs)


class _RateMeter:
    """Sliding window over (wall time, sample count) marks.

    ``advance(count)`` returns samples/sec once the window spans at least
    ``stride`` batches, else None; a backwards count (new epoch) re-arms.
    """

    def __init__(self, batch_size, stride):
        self.batch_size = batch_size
        self.stride = max(1, int(stride))
        self._mark = None          # (wall time, batch index) window start
        self._last = None          # most recent count, to detect rewinds

    def advance(self, nbatch):
        now = time.time()
        rewound = self._last is not None and nbatch < self._last
        self._last = nbatch
        if self._mark is None or rewound:
            self._mark = (now, nbatch)
            return None
        elapsed_batches = nbatch - self._mark[1]
        if elapsed_batches < self.stride or nbatch % self.stride:
            return None
        dt = max(now - self._mark[0], 1e-12)
        self._mark = (now, nbatch)
        return elapsed_batches * self.batch_size / dt


def do_checkpoint(prefix, period=1):
    """Epoch-end hook saving ``prefix-symbol.json`` / ``prefix-NNNN.params``
    in the reference's on-disk format (``python/mxnet/callback.py:39``)."""
    from .model import save_checkpoint
    hit = _periodic(period)

    def _save(epoch, sym, arg_params, aux_params):
        if hit(epoch):
            save_checkpoint(prefix, epoch + 1, sym, arg_params, aux_params)

    return _save


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end hook delegating to ``Module.save_checkpoint`` so optimizer
    state rides along (``python/mxnet/callback.py:11``)."""
    hit = _periodic(period)

    def _save(epoch, sym=None, arg_params=None, aux_params=None):
        if hit(epoch):
            mod.save_checkpoint(prefix, epoch + 1, save_optimizer_states)

    return _save


def log_train_metric(period, auto_reset=False):
    """Batch-end hook logging the running train metric
    (``python/mxnet/callback.py:62``)."""
    period = max(1, int(period))

    def _log(param):
        if param.nbatch % period:
            return
        _emit_metric(param.eval_metric, "Iter[%d] Batch[%d] Train-%s=%f",
                     param.epoch, param.nbatch, reset=auto_reset)

    return _log


class Speedometer:
    """Batch-end throughput + metric logger
    (``python/mxnet/callback.py:89``).

    Prints ``Speed: N samples/sec`` every ``frequent`` batches; when the
    batch counter rewinds (a new epoch) the window silently re-arms.
    """

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._meter = _RateMeter(batch_size, frequent)

    def __call__(self, param):
        speed = self._meter.advance(param.nbatch)
        if speed is None:
            return
        logged = _emit_metric(
            param.eval_metric,
            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
            param.epoch, param.nbatch, speed, reset=True)
        if not logged:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)


class ProgressBar:
    """Batch-end text progress bar (``python/mxnet/callback.py:132``)."""

    def __init__(self, total, length=80):
        self.total = max(1, int(total))
        self.bar_len = length

    def __call__(self, param):
        frac = min(param.nbatch / float(self.total), 1.0)
        ticks = int(round(self.bar_len * frac))
        bar = "=" * ticks + "-" * (self.bar_len - ticks)
        sys.stdout.write("[%s] %d%%\r" % (bar, int(frac * 100 + 0.999)))


class LogValidationMetricsCallback:
    """Epoch-end validation-metric logger
    (``python/mxnet/callback.py:155``)."""

    def __call__(self, param):
        _emit_metric(param.eval_metric, "Epoch[%d] Validation-%s=%f",
                     param.epoch)
