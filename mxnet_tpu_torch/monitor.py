"""Monitor (``mxnet_tpu/monitor.py``): a statistic of every op output,
for hunting NaNs and debugging.

Reference ``python/mxnet/monitor.py``, fed by the executor's per-node
tap (``src/executor/graph_executor.cc:757-778``).  ``tic()`` arms the
recorder on every ``interval``-th batch; while armed, the tap installed
on each executor appends ``(batch, name, stat)`` rows, the name
``"<node>_<output>"``; ``toc()`` adds the watched arguments, disarms and
renders the rows.  The tap keeps ``stat_func(x)``, never ``x``, so an
activation is released by the executor's walk as it would be without
the monitor.  The fused path's step is one CUDA graph and has no per-op
taps; ``Module.install_monitor`` warns there.
"""
from __future__ import annotations

import logging
import re

import torch

from .ndarray import NDArray


def _default_stat(x):
    """The scale-free magnitude ``||x||_2 / sqrt(n)``, as a one-element
    NDArray on ``x``'s device."""
    d = x.data
    norm = torch.sqrt(torch.sum(d * d)).reshape((1,))
    return NDArray(norm / (x.size ** 0.5))


class Monitor:
    """Watch the tensors whose name matches ``pattern`` every
    ``interval`` batches (reference ``python/mxnet/monitor.py:16-126``).
    ``stat_func`` maps an NDArray to an NDArray (by default
    ``||x||_2 / sqrt(n)``); ``sort=True`` orders a report by name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.sort = sort
        self._watch = re.compile(pattern).match
        self._armed = False
        self._batch = 0
        self._rows = []            # (batch, name, stat) while armed
        self._executors = []
        # executors call the tap as a plain function(name, array)
        self.stat_helper = self._record

    def _record(self, name, array):
        if self._armed and self._watch(name):
            self._rows.append((self._batch, name, self.stat_func(array)))

    def install(self, exe):
        """Install the tap on an executor (reference ``monitor.py:56``)."""
        exe.install_monitor(self.stat_helper)
        if all(e is not exe for e in self._executors):
            self._executors.append(exe)

    def tic(self):
        """Arm the recorder if this batch is due (reference
        ``monitor.py:68``)."""
        if self._batch % self.interval == 0:
            self._rows = []
            self._armed = True
        self._batch += 1

    def toc(self):
        """Disarm; add the watched arguments; return the rendered
        ``[(batch, name, stat string)]`` rows (reference
        ``monitor.py:82``)."""
        if not self._armed:
            return []
        for exe in self._executors:
            self._rows.extend(
                (self._batch, name, self.stat_func(arr))
                for name, arr in exe.arg_dict.items() if self._watch(name))
        self._armed = False
        rows, self._rows = self._rows, []
        if self.sort:
            rows.sort(key=lambda row: row[1])
        return [(batch, name, self._render(stat))
                for batch, name, stat in rows]

    @staticmethod
    def _render(stat):
        stats = stat if isinstance(stat, list) else [stat]
        return ",".join("%f" % float(s.asnumpy().reshape(-1)[0])
                        for s in stats)

    def toc_print(self):
        """``toc()``, each row logged (reference ``monitor.py:122``)."""
        for batch, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", batch, name, stat)
