"""Data iterators (``mxnet_tpu/io.py``): :class:`DataDesc`,
:class:`DataBatch`, the :class:`DataIter` protocol, :class:`NDArrayIter`
over in-memory arrays (reference ``python/mxnet/io.py:19-610``), the
wrappers (:class:`ResizeIter`, :class:`PrefetchingIter`), the record-file
image iterators (:class:`NativeImageRecordIter` over the port's own
native loader, :class:`PyImageRecordIter` with thread or process decode,
and the :func:`ImageRecordIter` factory), the staging and on-device
augment stages (:class:`DeviceUploadIter`, :class:`StreamAugmentIter`,
:class:`DeviceCacheIter`) and the reference's :class:`MNISTIter` and
:class:`CSVIter`.

The arrays of :class:`NDArrayIter` live on the current context (the card
unless a ``with mx.cpu():`` scope says otherwise); a batch is a view of
them.  Shuffling draws from :func:`mxnet_tpu_torch.random.np_rng`, as the
JAX package's does, so one seed gives the same order in both packages.
The record iterators' shuffles and the native loader's per-sample crops
are the JAX package's too; the on-device augment draws its crop offsets
and flips from a ``torch.Generator`` of its own, where the JAX package
draws from threefry keys.
"""
from __future__ import annotations

import contextlib
import logging
import os
import queue
import struct
import threading
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import _tsan
from . import faults as _faults
from . import obs as _obs
from . import random as _random
from . import recordio as _recordio
from .base import Context, MXNetError, current_context
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DeviceUploadIter", "StreamAugmentIter",
           "DeviceCacheIter", "MNISTIter", "CSVIter", "PyImageRecordIter",
           "NativeImageRecordIter", "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/dtype/layout descriptor (reference ``io.py:19-79``)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        desc = super().__new__(cls, name, shape)
        desc.dtype = dtype
        desc.layout = layout
        return desc

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape,
                                          self.dtype, self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch(object):
    """One batch: data/label lists of NDArray + padding info
    (reference ``io.py:82-123``)."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return "%s: data shapes: %s label shapes: %s" % (
            type(self).__name__, [d.shape for d in self.data],
            [l.shape for l in self.label] if self.label else [])


class DataIter(object):
    """Base iterator (reference ``io.py:126-213``)."""

    batch_size = 0

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def __next__(self):
        # fault-injection site: ``batch`` counts the batches this
        # iterator delivered over its life, so a failed fetch keeps its
        # index and a bounded retry asks again for the same batch
        fetched = getattr(self, "_faults_delivered", 0)
        if _faults.hit("io_error", site="iter_next", batch=fetched):
            raise OSError("injected io_error at %s batch %d"
                          % (type(self).__name__, fetched))
        batch = self.next()
        self._faults_delivered = fetched + 1
        return batch

    def reset(self):
        pass

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=self.getindex())

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Normalize data into a sorted list of (name, NDArray) pairs
    (reference ``io.py:424-452``)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    for k, v in data.items():
        if not isinstance(v, NDArray):
            # array() raises what it cannot take (and no CUDA device
            # when the current context is the card): no error is masked
            data[k] = array(v)
    return list(sorted(data.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``io.py:453-610``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            _random.np_rng().shuffle(self.idx)

            def _reorder(pairs):
                return [(k, array(v.asnumpy()[self.idx], ctx=v.context,
                                  dtype=v.dtype))
                        for k, v in pairs]

            self.data, self.label = _reorder(self.data), _reorder(self.label)

        if last_batch_handle == "discard":
            keep = self.data[0][1].shape[0] // batch_size * batch_size
            self.data = [(k, v[:keep]) for k, v in self.data]
            self.label = [(k, v[:keep]) for k, v in self.label]

        self.data_list = [v for _, v in self.data] + \
            [v for _, v in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.data_list[0].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    def _batch_descs(self, pairs):
        """Per-source descriptors with the batch dim swapped in."""
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in pairs]

    @property
    def provide_data(self):
        return self._batch_descs(self.data)

    @property
    def provide_label(self):
        return self._batch_descs(self.label)

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        # roll_over carries the unconsumed tail rows into the next epoch
        leftover = 0
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            leftover = (self.cursor % self.num_data) % self.batch_size
        self.cursor = leftover - self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            return [v[lo:hi] for _, v in source]
        # final short batch: wrap the pad rows around to the epoch start
        wrap = hi - self.num_data
        return [array(np.concatenate([v.asnumpy()[lo:],
                                      v.asnumpy()[:wrap]], axis=0),
                      ctx=v.context, dtype=v.dtype)
                for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        overrun = self.cursor + self.batch_size - self.num_data
        return overrun if (self.last_batch_handle == "pad"
                           and overrun > 0) else 0


# ----------------------------------------------------------------------
# wrappers
class _CurrentBatchAccessors(object):
    """The legacy DataIter getter protocol over ``self.current_batch``."""

    current_batch = None

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class ResizeIter(_CurrentBatchAccessors, DataIter):
    """Exactly ``size`` batches per epoch from another iterator, wrapping
    its epochs as needed (reference ``io.py:216-278``).  An inner
    iterator that yields no batch even after a reset raises
    :class:`MXNetError`, as the JAX package's does."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        bucket_key = getattr(data_iter, "default_bucket_key", None)
        if bucket_key is not None:
            self.default_bucket_key = bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur >= self.size:
            return False
        self.cur += 1
        for _ in range(2):
            try:
                self.current_batch = self.data_iter.next()
                return True
            except StopIteration:       # inner epoch ended: wrap, retry
                self.data_iter.reset()
        raise MXNetError("inner iterator yields no batches")

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


class _Producer(object):
    """One daemon thread that runs ``fn`` once per request and hands back
    ``(result, error)``: ``(None, None)`` when ``fn`` raised
    StopIteration."""

    def __init__(self, fn, name):
        self._fn = fn
        self._req = queue.Queue()
        self._res = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _loop(self):
        while self._req.get() is not None:
            try:
                out = (self._fn(), None)
            except StopIteration:
                out = (None, None)
            except BaseException as e:          # noqa: BLE001
                out = (None, e)
            self._res.put(out)

    def request(self):
        self._req.put(True)

    def result(self):
        return self._res.get()

    def close(self):
        self._req.put(None)


class PrefetchingIter(_CurrentBatchAccessors, DataIter):
    """Double-buffering prefetcher over one or more iterators (reference
    ``io.py:281-423``; C++ ``iter_prefetcher.h``).  Each wrapped iterator
    has one producer thread that makes its next batch while the consumer
    works on the current one.  ``MXNET_ENGINE_TYPE=NaiveEngine`` makes
    production synchronous, at the time it is asked for, as the
    reference's serial debugging engine does.  A producer's error is
    raised by the consumer's next ``next()``, and the stream goes on
    after it."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter < 1:
            raise MXNetError("PrefetchingIter needs at least one iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        naive = os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"
        self._producers = None if naive else [
            _Producer(it.next, "mxtpu-prefetch-%d" % i)
            for i, it in enumerate(iters)]
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        self._scheduled = [False] * self.n_iter
        self._errors = [None] * self.n_iter
        for i in range(self.n_iter):
            self._schedule(i)

    def _schedule(self, i):
        if self._producers is None:
            try:
                self.next_batch[i] = self.iters[i].next()
            except StopIteration:
                self.next_batch[i] = None
            except BaseException as e:          # noqa: BLE001
                self._errors[i] = e
                self.next_batch[i] = None
            return
        self._scheduled[i] = True
        self._producers[i].request()

    def _collect(self, i):
        if self._scheduled[i]:
            self._scheduled[i] = False
            self.next_batch[i], self._errors[i] = self._producers[i].result()

    def __del__(self):
        for p in getattr(self, "_producers", None) or []:
            p.close()

    @staticmethod
    def _renamed(rename_maps, per_iter_descs):
        if rename_maps is None:
            return [d for descs in per_iter_descs for d in descs]
        out = []
        for names, descs in zip(rename_maps, per_iter_descs):
            for d in descs:
                out.append(DataDesc(names[d.name], d.shape, d.dtype)
                           if isinstance(d, DataDesc) else DataDesc(*d))
        return out

    @property
    def provide_data(self):
        return self._renamed(self.rename_data,
                             [i.provide_data for i in self.iters])

    @property
    def provide_label(self):
        return self._renamed(self.rename_label,
                             [i.provide_label for i in self.iters])

    def reset(self):
        for i in range(self.n_iter):
            self._collect(i)
        for it in self.iters:
            it.reset()
        self._errors = [None] * self.n_iter
        for i in range(self.n_iter):
            self._schedule(i)

    def iter_next(self):
        for i in range(self.n_iter):
            self._collect(i)
        for i in range(self.n_iter):
            if self._errors[i] is not None:
                err, self._errors[i] = self._errors[i], None
                self._schedule(i)      # the stream goes on after the error
                raise err
        if self.next_batch[0] is None:
            for b in self.next_batch:
                assert b is None, \
                    "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Different pad number in the data batches"
        lead = self.next_batch[0]
        self.current_batch = DataBatch(
            [a for b in self.next_batch for a in b.data],
            [a for b in self.next_batch for a in b.label],
            lead.pad, lead.index, provide_data=self.provide_data,
            provide_label=self.provide_label)
        for i in range(self.n_iter):
            self._schedule(i)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


# ----------------------------------------------------------------------
# staging and on-device augment
def _torch_device(device):
    if device is None:
        return current_context().torch_device()
    if isinstance(device, Context):
        return device.torch_device()
    return torch.device(device)


class _Slot(object):
    """A host buffer of one batch member (pinned for a CUDA device), and
    the event of the host-to-device copy that last read it."""

    def __init__(self, shape, dtype, pin):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.copied = None


class DeviceUploadIter(_CurrentBatchAccessors, DataIter):
    """Stages each batch on the device ahead of its use (reference
    ``src/io/iter_prefetcher.h:28-129``: the next batch is staged through
    pinned memory while the current one computes).

    A worker thread pulls host batches from ``it``.  Each array is copied
    into one of ``depth`` host slots (pinned on a CUDA device) and from
    there, on a side stream, into a fresh device tensor, in ``chunks``
    row chunks (``copy_(non_blocking=True)``), so chunk ``k``'s transfer
    runs while chunk ``k + 1`` is still being copied into the slot.  The
    worker does not wait for the transfer: it records an event, and
    before it writes a slot again it waits for that slot's last
    transfer.  The consumer's stream waits on the batch's event in
    ``next()`` and the batch's tensors are marked as used on it
    (``record_stream``), so the allocator keeps their memory until the
    consumer's work on them is done.  Arrays already on the device pass
    through, behind an event of the worker's stream.  On the CPU the same
    thread, slots and queue run with no streams.  At most ``depth``
    staged batches wait in the queue.  An error of ``it`` reaches the
    consumer after the batches staged before it, and the next ``next()``
    asks ``it`` again, so a retry resumes where the stream failed.

    ``stats()`` reports where the worker's time went (``upload_s`` vs
    ``source_s``, aliased ``decode_wait_s``) and the consumer's view
    (``consumer_wait_s``, ``ready_ahead_frac``), with the JAX package's
    keys."""

    _END = object()

    # arrays below this size ship as one copy even when chunking is on
    CHUNK_MIN_BYTES = 1 << 20

    def __init__(self, it, device=None, depth=2, chunks=1,
                 chunk_min_bytes=None):
        super().__init__()
        self.it = it
        self.batch_size = getattr(it, "batch_size", 0)
        self._device = _torch_device(device)
        self._depth = max(1, int(depth))
        self._chunks = max(1, int(chunks or 1))
        self._chunk_min_bytes = self.CHUNK_MIN_BYTES \
            if chunk_min_bytes is None else int(chunk_min_bytes)
        self._cuda = self._device.type == "cuda"
        # the copies run on a side stream, and everything the worker's
        # inner iterators launch on a stream of the worker's own: nothing
        # touches the legacy default stream, which a CUDA-graph capture on
        # the consumer's thread must not see used
        self._side = torch.cuda.Stream(self._device) if self._cuda else None
        self._work = torch.cuda.Stream(self._device) if self._cuda else None
        # pinned slots by batch member, ``depth`` each, made at first use
        self._slots = {}
        self._turn = 0
        self._q = queue.Queue(self._depth)
        self._stop = threading.Event()
        self._err = None
        # the counters are written by both sides and read whole by
        # stats(): one lock, one snapshot; the values live in the obs
        # registry under this iterator's scope
        self._stats_lock = _tsan.lock("io.DeviceUploadIter._stats_lock")
        self._obs_scope = _obs.REGISTRY.scope("io.upload")
        self._c = {k: _obs.REGISTRY.counter(
            "%s.%s" % (self._obs_scope, k), initial=z)
            for k, z in (("upload_s", 0.0), ("source_s", 0.0),
                         ("consumer_wait_s", 0.0), ("batches_staged", 0),
                         ("ready_hits", 0), ("next_calls", 0))}
        self._worker = None
        self._ended = False
        self._nstaged = 0
        # the worker starts at the first next(): neither construction nor
        # a reset advances the wrapped iterator

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return self.it.provide_label

    # ------------------------------------------------------------------
    def _start_worker(self):
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-upload")
        self._worker.start()

    def _run(self):
        with torch.cuda.stream(self._work) if self._cuda \
                else contextlib.nullcontext():
            self._run_staged()

    def _run_staged(self):
        try:
            while not self._stop.is_set():
                # io.source: blocked on the inner iterator (decode);
                # io.upload: the copies into pinned memory and their launch
                corr = ("io%d" % self._nstaged) if _obs.OBS else None
                t0 = time.perf_counter()
                try:
                    with _obs.span("io.source", corr=corr, parent=None):
                        b = self.it.next()
                except StopIteration:
                    self._put(self._END)
                    return
                dt_src = time.perf_counter() - t0
                t0 = time.perf_counter()
                with _obs.span("io.upload", corr=corr, parent=None):
                    members = list(b.data) + list(b.label or [])
                    staged, event = self._upload(members)
                self._nstaged += 1
                with self._stats_lock:
                    if _tsan.TSAN:
                        _tsan.note_write("io.DeviceUploadIter.stats")
                    self._c["source_s"].inc(dt_src)
                    self._c["upload_s"].inc(time.perf_counter() - t0)
                    self._c["batches_staged"].inc()
                nd = len(b.data)
                out = DataBatch(data=staged[:nd], label=staged[nd:],
                                pad=b.pad, index=b.index,
                                provide_data=b.provide_data,
                                provide_label=b.provide_label)
                if not self._put((out, event)):
                    return
        except Exception as e:              # surfaced in the consumer
            self._err = e   # tsan: ok — published before the _END
            #                 sentinel, read after the queue hands it over
            self._put(self._END)

    def _upload(self, members):
        """The batch's arrays on the device, and the event the consumer
        waits on (None on the CPU)."""
        turn, self._turn = self._turn, (self._turn + 1) % self._depth
        out = []
        for i, a in enumerate(members):
            if isinstance(a, NDArray):
                a = a.data
            if isinstance(a, torch.Tensor) and a.device == self._device:
                out.append(NDArray(a))
                continue
            src = a if isinstance(a, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(a))
            out.append(NDArray(self._to_device(i, turn, src)))
        if not self._cuda:
            return out, None
        # the batch is ready once the side stream's copies and whatever the
        # worker's stream did to arrays already on the device are done
        worked = torch.cuda.Event()
        worked.record(torch.cuda.current_stream(self._device))
        self._side.wait_event(worked)
        event = torch.cuda.Event()
        event.record(self._side)
        return out, event

    def _to_device(self, member, turn, src):
        """``src`` in a fresh tensor on the device, copied through this
        member's host slot of this turn in row chunks."""
        key = (member, tuple(src.shape), src.dtype)
        ring = self._slots.get(key)
        if ring is None:
            ring = self._slots[key] = [None] * self._depth
        if ring[turn] is None:
            ring[turn] = _Slot(src.shape, src.dtype, pin=self._cuda)
        slot = ring[turn]
        if slot.copied is not None:     # the slot's last transfer is done
            slot.copied.synchronize()
        side = torch.cuda.stream(self._side) if self._cuda \
            else contextlib.nullcontext()
        with side:
            dst = torch.empty(src.shape, dtype=src.dtype,
                              device=self._device)
        n = src.shape[0] if src.dim() else 0
        k = self._chunks if (self._chunks > 1 and n >= self._chunks and
                             src.numel() * src.element_size()
                             >= self._chunk_min_bytes) else 1
        parts = [slice(int(lo), int(hi)) for lo, hi in zip(
            np.linspace(0, n, k + 1)[:-1], np.linspace(0, n, k + 1)[1:])] \
            if src.dim() else [...]
        for part in parts:
            slot.host[part].copy_(src[part])
            with side:
                dst[part].copy_(slot.host[part], non_blocking=self._cuda)
        if self._cuda:
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._side)
        return dst

    def _put(self, item):
        if _tsan.TSAN:
            _tsan.note_write("io.DeviceUploadIter.staging", lockfree=True,
                             reason="queue.Queue handoff (internal lock)")
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _shutdown_worker(self):
        self._stop.set()
        while self._worker is not None and self._worker.is_alive():
            try:                            # unblock a full-queue put
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._worker.join(timeout=0.05)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        try:
            self._shutdown_worker()
        except Exception:                   # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    def reset(self):
        self._shutdown_worker()
        self.it.reset()
        self._ended = False
        self._nstaged = 0
        self._err = None      # a stale worker error must not resurface

    def next(self):
        if self._ended:                 # exhausted: repeatable, no hang
            raise StopIteration
        if self._worker is None or not (self._worker.is_alive()
                                        or self._q.qsize()):
            self._start_worker()
        ready = bool(self._q.qsize())   # staged ahead of the ask
        t0 = time.perf_counter()
        if _tsan.TSAN:
            _tsan.note_read("io.DeviceUploadIter.staging", lockfree=True,
                            reason="queue.Queue handoff (internal lock)")
        with _obs.span("io.wait",
                       attrs={"ready": ready} if _obs.OBS else None):
            item = self._q.get()
        dt_wait = time.perf_counter() - t0
        with self._stats_lock:
            if _tsan.TSAN:
                _tsan.note_write("io.DeviceUploadIter.stats")
            self._c["next_calls"].inc()
            if ready:
                self._c["ready_hits"].inc()
            self._c["consumer_wait_s"].inc(dt_wait)
        if item is self._END:
            if self._err is not None:
                # a failed fetch is not the end: the worker has stopped
                # after the batches it staged before the failure, and the
                # next call starts another at the batch that failed, so a
                # retried transient error loses no batch
                err, self._err = self._err, None
                self._worker.join()
                self._worker = None
                raise err
            self._ended = True
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for a in list(batch.data) + list(batch.label):
                a.data.record_stream(consumer)
        self.current_batch = batch
        return batch

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def stats(self):
        """Per-stage wall attribution, one snapshot under the stats lock:
        ``upload_s`` (copies into pinned memory and their launch, the
        waits for a free slot included) vs ``source_s`` (aliased
        ``decode_wait_s``: blocked on the inner iterator) on the worker;
        ``consumer_wait_s`` (blocked on the queue) and
        ``ready_ahead_frac`` (the share of ``next()`` calls served from a
        batch already staged) on the consumer."""
        with self._stats_lock:
            if _tsan.TSAN:
                _tsan.note_read("io.DeviceUploadIter.stats")
            upload_s = self._c["upload_s"].value
            source_s = self._c["source_s"].value
            consumer_wait_s = self._c["consumer_wait_s"].value
            staged = self._c["batches_staged"].value
            hits = self._c["ready_hits"].value
            calls = self._c["next_calls"].value
        return {"upload_s": round(upload_s, 3),
                "source_s": round(source_s, 3),
                "decode_wait_s": round(source_s, 3),
                "consumer_wait_s": round(consumer_wait_s, 3),
                "ready_ahead_frac": round(hits / calls, 3)
                if calls else None,
                "batches_staged": staged,
                "chunks": self._chunks,
                "depth": self._depth}

    @property
    def upload_s(self):
        return self._c["upload_s"].value

    @property
    def source_s(self):
        return self._c["source_s"].value

    @property
    def consumer_wait_s(self):
        return self._c["consumer_wait_s"].value

    @property
    def batches_staged(self):
        return self._c["batches_staged"].value


def _as_tensor(a, device):
    """A batch member as a tensor on ``device`` (uploaded if it is a host
    array)."""
    if isinstance(a, NDArray):
        a = a.data
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


class _DeviceAugment(object):
    """The on-device augment shared by :class:`DeviceCacheIter` (batches
    gathered out of the cache by index) and :class:`StreamAugmentIter`
    (batches arriving whole): random-or-center crop, random mirror and
    the optional mean/std (emitting float32), as one advanced-index
    gather per batch (the JAX package's ``_make_device_augment``).  Rows
    are ``oy[:, None] + arange(ch)``, columns ``ox + arange(cw)``,
    reversed where ``flip`` is set, and the batch index (the cache rows)
    is the first index.  Crop offsets and flips are drawn from a
    ``torch.Generator`` on the frames' device seeded with ``seed``;
    ``last_draw`` holds the last batch's ``(oy, ox, flip)``."""

    def __init__(self, crop, rand_crop, rand_mirror, mean, std, seed, device):
        self.crop = crop
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.device = device
        self.mean = None if mean is None else \
            torch.as_tensor(mean, dtype=torch.float32).to(device)
        self.std = None if std is None else \
            torch.as_tensor(std, dtype=torch.float32).to(device)
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.last_draw = None

    def __call__(self, frames, index=None):
        """``frames[index]`` (all of ``frames`` when ``index`` is None),
        cropped, mirrored and normalised: ``(B, ch, cw, C)``."""
        ch, cw = self.crop
        H, W = frames.shape[1], frames.shape[2]
        dev = frames.device
        if index is None:
            index = torch.arange(frames.shape[0], device=dev)
        B = index.shape[0]
        if self.rand_crop and (H > ch or W > cw):
            oy = torch.randint(0, H - ch + 1, (B,), generator=self.gen,
                               device=dev)
            ox = torch.randint(0, W - cw + 1, (B,), generator=self.gen,
                               device=dev)
        else:
            oy = torch.full((B,), (H - ch) // 2, device=dev)
            ox = torch.full((B,), (W - cw) // 2, device=dev)
        cols = torch.arange(cw, device=dev).expand(B, cw)
        if self.rand_mirror:
            flip = torch.rand((B,), generator=self.gen, device=dev) < 0.5
            cols = torch.where(flip[:, None], cw - 1 - cols, cols)
        else:
            flip = torch.zeros((B,), dtype=torch.bool, device=dev)
        rows = oy[:, None] + torch.arange(ch, device=dev)
        cols = ox[:, None] + cols
        out = frames[index[:, None, None], rows[:, :, None],
                     cols[:, None, :]]
        self.last_draw = (oy, ox, flip)
        if self.mean is not None or self.std is not None:
            out = out.to(torch.float32)
            if self.mean is not None:
                out = out - self.mean
            if self.std is not None:
                out = out / self.std
        return out


def _check_stats(what_frames, chans, mean, std):
    for what, v in (("mean", mean), ("std", std)):
        if v is not None and np.asarray(v).size not in (1, chans):
            raise MXNetError("%s has %d entries but %s have %d channels"
                             % (what, np.asarray(v).size, what_frames,
                                chans))
    return (None if mean is None else np.asarray(mean, np.float32),
            None if std is None else np.asarray(std, np.float32))


class StreamAugmentIter(_CurrentBatchAccessors, DataIter):
    """On-device augment for the streaming input path: wraps an iterator
    of uint8 NHWC frame batches (host arrays, or already on the device as
    :class:`DeviceUploadIter` stages them) and crops, mirrors and
    normalises each batch on the device (``mxnet_tpu/io.py:726``).

    Augments that shrink the batch (the crop) belong before the wire, in
    the decode workers; mirror, normalisation and the float cast belong
    here.  With ``data_shape`` smaller than the incoming frames this
    iterator also crops."""

    def __init__(self, inner, data_shape=None, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, seed=0,
                 device=None):
        super().__init__(getattr(inner, "batch_size", 0))
        self.it = inner
        self._device = _torch_device(device)
        desc = inner.provide_data[0]
        if len(desc.shape) != 4:
            raise MXNetError(
                "StreamAugmentIter expects NHWC frame batches, got "
                "shape %s from %s" % (desc.shape, type(inner).__name__))
        _, H, W, C = desc.shape
        if data_shape is None:
            ch, cw = int(H), int(W)
        else:
            ch, cw = int(data_shape[-2]), int(data_shape[-1])
        if ch > H or cw > W:
            raise MXNetError("crop %s exceeds incoming frames %s"
                             % ((ch, cw), (H, W)))
        self._crop = (ch, cw)
        self._chans = int(C)
        self._mean, self._std = _check_stats("frames", self._chans, mean,
                                             std)
        self._aug = _DeviceAugment(self._crop, bool(rand_crop),
                                   bool(rand_mirror), self._mean, self._std,
                                   seed, self._device)

    @property
    def last_draw(self):
        return self._aug.last_draw

    @property
    def provide_data(self):
        desc = self.it.provide_data[0]
        out_t = np.float32 if (self._mean is not None
                               or self._std is not None) else desc.dtype
        ch, cw = self._crop
        return [DataDesc(desc.name, (desc.shape[0], ch, cw, self._chans),
                         out_t)]

    @property
    def provide_label(self):
        return self.it.provide_label

    def reset(self):
        self.it.reset()

    def stats(self):
        inner = getattr(self.it, "stats", None)
        return inner() if callable(inner) else {}

    def next(self):
        b = self.it.next()
        out = self._aug(_as_tensor(b.data[0], self._device))
        label = [NDArray(_as_tensor(b.label[0], self._device))] \
            if b.label else []
        self.current_batch = DataBatch(
            data=[NDArray(out)], label=label, pad=b.pad, index=b.index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        return self.current_batch

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False


class DeviceCacheIter(_CurrentBatchAccessors, DataIter):
    """Device-resident dataset cache (``mxnet_tpu/io.py:826``): the inner
    iterator is streamed once, each host batch uploaded as it arrives and
    the parts concatenated on the device; every batch after that is one
    index upload, then the gather, crop, mirror and optional mean/std on
    the device.

    ``inner`` yields host batches at the storage size (e.g.
    ``NativeImageRecordIter(..., output="numpy", dtype="uint8",
    layout="NHWC")`` at 256 x 256); ``data_shape`` (h, w) is the crop
    emitted per batch, random with ``rand_crop`` else centred.  The order
    is shuffled per epoch by a numpy ``RandomState(seed)``, as the JAX
    package's is; labels are kept as float32."""

    def __init__(self, inner, data_shape=None, rand_crop=False,
                 rand_mirror=False, shuffle=False, seed=0,
                 batch_size=None, device=None, mean=None, std=None):
        super().__init__(int(batch_size or inner.batch_size))
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.shuffle = bool(shuffle)
        self._epoch = 0
        self._rng = np.random.RandomState(seed)
        self._device = _torch_device(device)
        self.data_name = inner.provide_data[0].name
        self.label_name = inner.provide_label[0].name
        dparts, lparts, n = [], [], 0
        for b in inner:
            fresh = b.data[0].shape[0] - (b.pad or 0)
            dparts.append(_as_tensor(b.data[0], self._device)[:fresh])
            lparts.append(_as_tensor(b.label[0], self._device)[:fresh]
                          .to(torch.float32))
            n += fresh
        if not n:
            raise MXNetError("DeviceCacheIter: inner iterator is empty")
        self._data = torch.cat(dparts, dim=0)
        self._label = torch.cat(lparts, dim=0)
        del dparts, lparts
        self.num_data = n
        sh, sw = self._data.shape[1], self._data.shape[2]
        ch, cw = (sh, sw) if data_shape is None else \
            (data_shape[-2], data_shape[-1])
        if ch > sh or cw > sw:
            raise MXNetError("crop %s exceeds cached frames %s"
                             % ((ch, cw), (sh, sw)))
        self._crop = (int(ch), int(cw))
        chans = int(self._data.shape[-1])
        self._mean, self._std = _check_stats("cached frames", chans, mean,
                                             std)
        self._aug = _DeviceAugment(self._crop, self.rand_crop,
                                   self.rand_mirror, self._mean, self._std,
                                   seed, self._device)
        self._order = np.arange(n)
        self.cursor = -self.batch_size
        if self.shuffle:
            self._rng.shuffle(self._order)

    @property
    def last_draw(self):
        return self._aug.last_draw

    @property
    def provide_data(self):
        ch, cw = self._crop
        shape = (self.batch_size, ch, cw, int(self._data.shape[-1]))
        out_t = np.float32 if (self._mean is not None
                               or self._std is not None) \
            else torch.empty((), dtype=self._data.dtype).numpy().dtype
        return [DataDesc(self.data_name, shape, out_t)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) + tuple(self._label.shape[1:])
        return [DataDesc(self.label_name, shape, np.float32)]

    def cache_nbytes(self):
        return int(self._data.numel() * self._data.element_size()
                   + self._label.numel() * self._label.element_size())

    def reset(self):
        self.cursor = -self.batch_size
        self._epoch += 1
        if self.shuffle:
            self._rng.shuffle(self._order)

    def iter_next(self):
        """Advance the cursor and stage ``current_batch``."""
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            return False
        lo = self.cursor
        hi = lo + self.batch_size
        pad = max(0, hi - self.num_data)
        rows = np.take(self._order, np.arange(lo, hi), mode="wrap")
        index = torch.from_numpy(rows.astype(np.int64)).to(self._device)
        imgs = self._aug(self._data, index)
        self.current_batch = DataBatch(
            data=[NDArray(imgs)], label=[NDArray(self._label[index])],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)
        return True

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return self.current_batch


# ----------------------------------------------------------------------
# the reference's C++ iterators
def _parse_bool(v):
    if isinstance(v, str):
        return v.lower() in ("true", "1", "yes")
    return bool(v)


def _as_shape(s):
    if isinstance(s, str):
        import ast
        s = ast.literal_eval(s)
    if isinstance(s, int):
        return (s,)
    return tuple(int(x) for x in s)


def _maybe_gzip(path):
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rb")
    return open(path, "rb")


class _DelegatingIter(DataIter):
    """An iterator that hands every call to an inner ``self._iter``."""

    provide_data = property(lambda self: self._iter.provide_data)
    provide_label = property(lambda self: self._iter.provide_label)

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()


class MNISTIter(_DelegatingIter):
    """MNIST idx-ubyte reader (reference ``src/io/iter_mnist.cc``)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 part_index=0, num_parts=1, **kwargs):
        super().__init__(int(batch_size))
        img = self._read_images(image)
        lbl = self._read_labels(label)
        assert img.shape[0] == lbl.shape[0]
        if int(num_parts) > 1:
            n = img.shape[0] // int(num_parts)
            s = int(part_index) * n
            img, lbl = img[s:s + n], lbl[s:s + n]
        if _parse_bool(shuffle):
            perm = np.random.RandomState(int(seed)).permutation(img.shape[0])
            img, lbl = img[perm], lbl[perm]
        img = img.astype(np.float32) / 255.0
        if _parse_bool(flat):
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, 28, 28)
        self._iter = NDArrayIter(img, lbl.astype(np.float32),
                                 batch_size=int(batch_size),
                                 data_name="data", label_name="softmax_label")
        if not _parse_bool(silent):
            logging.info("MNISTIter: load %d images", img.shape[0])

    @staticmethod
    def _read_images(path):
        with _maybe_gzip(path) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("invalid MNIST image file %s" % path)
            return np.frombuffer(f.read(num * rows * cols),
                                 dtype=np.uint8).reshape(num, rows, cols)

    @staticmethod
    def _read_labels(path):
        with _maybe_gzip(path) as f:
            magic, num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("invalid MNIST label file %s" % path)
            return np.frombuffer(f.read(num), dtype=np.uint8)


class CSVIter(_DelegatingIter):
    """CSV reader (reference ``src/io/iter_csv.cc``)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        super().__init__(int(batch_size))
        data_shape = _as_shape(data_shape)
        label_shape = _as_shape(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + label_shape)
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._iter = NDArrayIter(
            data, label, batch_size=int(batch_size),
            last_batch_handle="pad" if _parse_bool(round_batch)
            else "discard", data_name="data", label_name="label")


# ----------------------------------------------------------------------
# record-file image iterators
def _shard_contiguous(items, num_parts, part_index):
    """Contiguous ``num_parts`` sharding with the remainder spread over
    the first parts: every record lands in exactly one part."""
    if num_parts <= 1:
        return list(items)
    if not 0 <= part_index < num_parts:
        raise MXNetError("part_index %d out of range for num_parts %d"
                         % (part_index, num_parts))
    base, rem = divmod(len(items), num_parts)
    start = part_index * base + min(part_index, rem)
    stop = start + base + (1 if part_index < rem else 0)
    return list(items[start:stop])


class _RemoteDecodeTraceback(Exception):
    """Carries a decode worker's formatted traceback as the
    ``__cause__`` of the re-raised original exception."""

    def __init__(self, tb):
        super().__init__("\n--- decode worker traceback ---\n%s" % tb)


class _ProcessDecodeRing:
    """Parent side of the multi-process decode ring
    (``_decode_worker.worker_main`` holds the child side's protocol).
    Each worker owns a ``depth``-slot shared-memory ring; batches go to
    the workers round-robin, the parent puts them back in order, copies
    each slab out the moment it arrives and bounds host memory at
    ``workers x depth`` batch slabs.  ``submit_epoch`` invalidates work
    in flight by bumping the shared epoch value; ``close`` joins the
    workers and unlinks every slab."""

    def __init__(self, rec_path, slab_shape, label_width, workers, depth,
                 resize, rand_crop, rand_mirror, seed, crop,
                 start_method=None):
        import multiprocessing as mp
        from multiprocessing import shared_memory
        from . import _decode_worker
        start_method = start_method or os.environ.get(
            "MXTPU_DECODE_START_METHOD", "spawn")
        self._ctx = mp.get_context(start_method)
        self._closed = False
        self._workers = []
        self._stash = {}
        self._expected = 0
        self._next_seq = 0
        self._delivered = 0
        self._epoch = 0
        self._depth = max(1, int(depth))
        self._slab_shape = tuple(int(s) for s in slab_shape)
        self._result_q = self._ctx.Queue()
        self._epoch_val = self._ctx.Value("i", 0)
        nbytes = int(np.prod(self._slab_shape)) * self._depth
        try:
            for wid in range(max(1, int(workers))):
                shm = shared_memory.SharedMemory(create=True, size=nbytes)
                try:
                    task_q = self._ctx.Queue()
                    sem = self._ctx.Semaphore(self._depth)
                    cfg = {"wid": wid, "rec_path": rec_path,
                           "shm_name": shm.name, "depth": self._depth,
                           "slab_shape": self._slab_shape,
                           "label_width": int(label_width),
                           "resize": int(resize), "crop": tuple(crop),
                           "rand_crop": bool(rand_crop),
                           "rand_mirror": bool(rand_mirror),
                           "seed": int(seed)}
                    proc = self._ctx.Process(
                        target=_decode_worker.worker_main,
                        args=(cfg, task_q, self._result_q, sem,
                              self._epoch_val),
                        daemon=True, name="mxtpu-decode-%d" % wid)
                    proc.start()
                    view = np.ndarray((self._depth,) + self._slab_shape,
                                      dtype=np.uint8, buffer=shm.buf)
                except BaseException:
                    shm.close()
                    shm.unlink()
                    raise
                self._workers.append({"proc": proc, "shm": shm,
                                      "task_q": task_q, "sem": sem,
                                      "view": view})
        except BaseException:
            self.close()
            raise

    def submit_epoch(self, batches):
        """Assign one epoch of ``(offsets, pad, indices)`` batch tasks
        round-robin over the workers."""
        self._epoch += 1
        with self._epoch_val.get_lock():
            self._epoch_val.value = self._epoch
        self._stash.clear()
        self._expected = len(batches)
        self._next_seq = 0
        self._delivered = 0
        W = len(self._workers)
        for seq, (offsets, pad, idxs) in enumerate(batches):
            self._workers[seq % W]["task_q"].put(
                (self._epoch, seq, list(offsets), int(pad),
                 np.asarray(idxs)))

    def _receive(self, deadline, timeout):
        while True:
            try:
                return self._result_q.get(timeout=0.2)
            except queue.Empty:
                dead = [w["proc"].name for w in self._workers
                        if not w["proc"].is_alive()]
                if dead:
                    raise MXNetError(
                        "decode worker(s) %s died without reporting — "
                        "ring aborted" % ", ".join(dead))
                if time.monotonic() > deadline:
                    raise MXNetError(
                        "decode ring stalled: no batch within %.0f s "
                        "(epoch %d, waiting for batch %d of %d)"
                        % (timeout, self._epoch, self._next_seq,
                           self._expected))

    def next_batch(self, timeout=300.0):
        """The next in-order batch as ``(uint8 NHWC data, labels, pad,
        indices)``, or None at the epoch's end.  A batch whose decode
        failed re-raises the worker's exception, its traceback attached
        as ``__cause__``; the stream goes on past it."""
        if self._delivered >= self._expected:
            return None
        deadline = time.monotonic() + timeout
        while self._next_seq not in self._stash:
            msg = self._receive(deadline, timeout)
            kind, wid, epoch, seq = msg[0], msg[1], msg[2], msg[3]
            w = self._workers[wid]
            if kind == "ok":
                slot, labels, pad, idxs = msg[4], msg[5], msg[6], msg[7]
                if epoch != self._epoch:
                    w["sem"].release()      # stale: recycle the slot
                    continue
                data = np.array(w["view"][slot])
                w["sem"].release()
                self._stash[seq] = ("ok", (data, labels, pad, idxs))
            else:
                if epoch != self._epoch:
                    continue
                self._stash[seq] = ("err", (msg[4], msg[5]))
        kind, payload = self._stash.pop(self._next_seq)
        self._next_seq += 1
        self._delivered += 1
        if kind == "err":
            exc, tb = payload
            raise exc from _RemoteDecodeTraceback(tb)
        return payload

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            with self._epoch_val.get_lock():
                self._epoch_val.value = -1  # parked workers bail out
        except Exception:                   # noqa: BLE001
            pass
        for w in self._workers:
            try:
                w["task_q"].put(None)
            except Exception:               # noqa: BLE001
                pass
        for w in self._workers:
            w["proc"].join(timeout=5.0)
            if w["proc"].is_alive():
                w["proc"].terminate()
                w["proc"].join(timeout=2.0)
        try:
            while True:
                self._result_q.get_nowait()
        except (queue.Empty, OSError, ValueError):
            pass
        self._result_q.close()
        for w in self._workers:
            try:
                w["task_q"].close()
            except Exception:               # noqa: BLE001
                pass
            w["view"] = None
            w["shm"].close()
            try:
                w["shm"].unlink()
            except FileNotFoundError:
                pass
        self._workers = []

    def __del__(self):
        try:
            self.close()
        except Exception:                   # noqa: BLE001
            pass


class PyImageRecordIter(DataIter):
    """RecordIO image iterator with threaded or multi-process decode
    (``mxnet_tpu/io.py:1449``; reference
    ``src/io/iter_image_recordio_2.cc:28-120`` + ``image_aug_default.cc``).

    ``preprocess_mode="thread"`` decodes on a thread pool behind a
    producer thread and emits float CHW batches (BGR, normalised).
    ``"process"`` spawns ``decode_workers`` processes
    (``_decode_worker.worker_main``), each decoding its batches to uint8
    NHWC into a shared-memory ring; it refuses mean/std/scale, which
    belong on the device.  ``output="numpy"`` keeps batches on the host
    (one crossing, owned by :class:`DeviceUploadIter`); ``"ndarray"``
    puts them on the current context."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_img=None,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, resize=-1, max_random_scale=1.0,
                 min_random_scale=1.0, max_rotate_angle=0,
                 max_aspect_ratio=0.0, random_h=0, random_s=0, random_l=0,
                 preprocess_threads=4, prefetch_buffer=4, part_index=0,
                 num_parts=1, round_batch=True, seed=0, data_name="data",
                 label_name="softmax_label", preprocess_mode="thread",
                 decode_workers=None, output="ndarray", **kwargs):
        super().__init__(int(batch_size))
        self.data_shape = _as_shape(data_shape)
        assert len(self.data_shape) == 3, "data_shape must be (c, h, w)"
        if preprocess_mode not in ("thread", "process"):
            raise MXNetError("preprocess_mode must be thread or process, "
                             "got %r" % (preprocess_mode,))
        if output not in ("ndarray", "numpy"):
            raise MXNetError("output must be ndarray or numpy, got %r"
                             % (output,))
        self.preprocess_mode = preprocess_mode
        self.output = output
        self.label_width = int(label_width)
        self.shuffle = _parse_bool(shuffle)
        self.rand_crop = _parse_bool(rand_crop)
        self.rand_mirror = _parse_bool(rand_mirror)
        self.round_batch = _parse_bool(round_batch)
        self.scale = float(scale)
        self.resize = int(resize)
        self.mean = None
        if mean_img is not None and os.path.isfile(str(mean_img)):
            from . import ndarray as nd
            m = nd.load(str(mean_img))
            self.mean = list(m.values())[0].asnumpy() \
                if isinstance(m, dict) else m[0].asnumpy()
        elif float(mean_r) or float(mean_g) or float(mean_b):
            self.mean = np.array([float(mean_b), float(mean_g),
                                  float(mean_r)]).reshape(3, 1, 1)
        self.std = np.array([float(std_b), float(std_g),
                             float(std_r)]).reshape(3, 1, 1)
        if self.preprocess_mode == "process":
            if type(self) is not PyImageRecordIter:
                raise MXNetError(
                    "preprocess_mode='process' supports plain image "
                    "records only (%s overrides the decode hook; use "
                    "thread mode)" % type(self).__name__)
            if self.mean is not None or self.scale != 1.0 or \
                    not np.all(self.std == 1.0):
                raise MXNetError(
                    "preprocess_mode='process' ships raw uint8 NHWC: "
                    "mean/std/scale must be identity — normalize on "
                    "device instead (StreamAugmentIter or the fused "
                    "trainer's cast)")
        self.data_name = data_name
        self.label_name = label_name
        self._seed = int(seed)
        self.rng = np.random.RandomState(self._seed)
        self._rec_path = path_imgrec
        guess = os.path.splitext(path_imgrec)[0] + ".idx"
        if path_imgidx or os.path.isfile(guess):
            self._record = _recordio.MXIndexedRecordIO(
                path_imgidx or guess, path_imgrec, "r")
        else:
            self._record = _recordio.MXRecordIO(path_imgrec, "r")
        if isinstance(self._record, _recordio.MXIndexedRecordIO) \
                and self._record.keys:
            self._offsets = self._record.offsets()
        else:
            from . import _decode_worker
            self._offsets = _decode_worker.scan_offsets(path_imgrec)
        self._offsets = _shard_contiguous(self._offsets, int(num_parts),
                                          int(part_index))
        self._order = np.arange(len(self._offsets))
        self._ring = None
        self._ring_depth = max(2, int(prefetch_buffer))
        self._decode_workers = max(1, int(decode_workers
                                          or preprocess_threads or 1))
        self._pool = None
        if self.preprocess_mode == "thread":
            self._pool = ThreadPoolExecutor(
                max_workers=int(preprocess_threads))
        self._queue = queue.Queue(maxsize=int(prefetch_buffer))
        self._producer = None
        self._stop = threading.Event()
        self._epoch_done = False
        self.reset()

    @property
    def provide_data(self):
        if self.preprocess_mode == "process":
            c, h, w = self.data_shape
            return [DataDesc(self.data_name,
                             (self.batch_size, h, w, c), np.uint8)]
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def _epoch_batches(self):
        """``(record indices, pad)`` per batch: ``round_batch`` wraps the
        ragged tail from the epoch's start, else drops it."""
        bs = self.batch_size
        out = []
        for i in range(0, len(self._order), bs):
            idxs = self._order[i:i + bs]
            pad = bs - len(idxs)
            if pad > 0:
                if not self.round_batch:
                    break
                idxs = np.concatenate([
                    idxs, np.take(self._order, np.arange(pad),
                                  mode="wrap")])
            out.append((idxs, pad))
        return out

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self._order)
        self._epoch_done = False
        if self.preprocess_mode == "process":
            if self._ring is None:
                c, h, w = self.data_shape
                self._ring = _ProcessDecodeRing(
                    rec_path=self._rec_path,
                    slab_shape=(self.batch_size, h, w, c),
                    label_width=self.label_width,
                    workers=self._decode_workers,
                    depth=self._ring_depth, resize=self.resize,
                    rand_crop=self.rand_crop,
                    rand_mirror=self.rand_mirror, seed=self._seed,
                    crop=(h, w))
            self._ring.submit_epoch(
                [([self._offsets[j] for j in idxs], pad, idxs.copy())
                 for idxs, pad in self._epoch_batches()])
            return
        self._drain()
        self._stop.clear()
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="mxtpu-decode")
        self._producer.start()

    def close(self):
        """Tear the decode pipeline down: the process ring (workers and
        shared-memory slabs) and the thread producer.  Idempotent."""
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        if self._producer is not None and \
                self._producer is not threading.current_thread():
            self._drain()

    def __del__(self):
        try:
            self.close()
        except Exception:                   # noqa: BLE001
            pass

    def _drain(self):
        if self._producer is None:
            return
        self._stop.set()
        for _ in range(2):
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            if self._producer.is_alive():
                self._producer.join(timeout=5.0)
        self._producer = None

    def _read_record(self, offset):
        self._record.seek_to(offset)
        return self._record.read()

    def _decode_one(self, raw):
        header, img = _recordio.unpack_img(raw)
        label = np.asarray(header.label, dtype=np.float32) \
            if header.flag > 0 else np.float32(header.label)
        return self._augment(img), label

    def _augment(self, img):
        """resize -> crop -> mirror (the shared spatial stage) ->
        normalise; CHW float out."""
        from ._decode_worker import spatial_augment
        c, h, w = self.data_shape
        img = spatial_augment(img, h, w, self.resize, self.rand_crop,
                              self.rand_mirror, self.rng)
        chw = img.transpose(2, 0, 1).astype(np.float32)
        if self.mean is not None:
            chw = chw - self.mean
        chw = chw / self.std
        return chw * self.scale

    def _produce(self):
        try:
            self._produce_impl()
        except BaseException as e:  # surfaced in next(); never deadlock
            self._queue.put(e)
            self._queue.put(None)

    def _produce_impl(self):
        bs = self.batch_size
        for idxs, pad in self._epoch_batches():
            if self._stop.is_set():
                return
            raws = [self._read_record(self._offsets[j]) for j in idxs]
            decoded = list(self._pool.map(self._decode_one, raws))
            data = np.stack([d for d, _ in decoded])
            labels = np.stack([l for _, l in decoded])
            if self.label_width == 1:
                labels = labels.reshape(bs)
            item = (data, labels, pad, idxs.copy())
            while not self._stop.is_set():  # never drop a decoded batch
                try:
                    self._queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set():
                return
        self._queue.put(None)

    def _batch(self, data, labels, pad, idxs):
        if self.output == "numpy":
            return DataBatch(data=[data], label=[labels], pad=pad,
                             index=idxs)
        return DataBatch(data=[array(data)], label=[array(labels)],
                         pad=pad, index=idxs)

    def next(self):
        if self.preprocess_mode == "process":
            if self._epoch_done:
                raise StopIteration
            item = self._ring.next_batch()
            if item is None:
                self._epoch_done = True
                raise StopIteration
            data, labels, pad, idxs = item
            if self.label_width == 1:
                labels = labels.reshape(self.batch_size)
            return self._batch(data, labels, pad, idxs)
        item = self._queue.get()
        if item is None:
            self._epoch_done = True
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return self._batch(*item)

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False


class NativeImageRecordIter(DataIter):
    """RecordIO image iterator backed by the port's native loader
    (``csrc/dataloader.cc``, built at first use by
    :mod:`mxnet_tpu_torch._native`): JPEG/PNG decode and augment on a C++
    thread pool, no GIL (``mxnet_tpu/io.py:1777``).  The same record
    bytes, augments (resize-short, random/center crop, mirror, mean/std)
    and BGR output as the Python path; ``layout="NHWC"`` decodes
    channels-last, ``dtype="uint8"`` emits the raw bytes (identity
    normalisation only), ``output="numpy"`` keeps batches on the host."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, resize=-1, preprocess_threads=4,
                 part_index=0, num_parts=1, seed=0, data_name="data",
                 label_name="softmax_label", layout="NCHW",
                 output="ndarray", dtype="float32", **kwargs):
        super().__init__(int(batch_size))
        import ctypes
        from ._native import dataloader_lib
        self._handle = None
        self._lib = dataloader_lib()
        self.data_shape = _as_shape(data_shape)
        if len(self.data_shape) != 3:
            raise MXNetError("data_shape must be (c, h, w), got %s"
                             % (self.data_shape,))
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC, got %r" % layout)
        self.layout = layout
        if output not in ("ndarray", "numpy"):
            raise MXNetError("output must be ndarray or numpy, got %r"
                             % output)
        self.output = output
        if dtype not in ("float32", "uint8"):
            raise MXNetError("dtype must be float32 or uint8, got %r"
                             % dtype)
        if dtype == "uint8" and not (
                mean_r == mean_g == mean_b == 0.0
                and std_r == std_g == std_b == 1.0 and scale == 1.0):
            raise MXNetError(
                "dtype='uint8' emits raw bytes: mean/std/scale must be "
                "identity (normalize on device instead)")
        self.dtype = np.dtype(dtype)
        self.label_width = int(label_width)
        if self.label_width < 1:
            raise MXNetError("label_width must be >= 1")
        self.data_name = data_name
        self.label_name = label_name
        c, h, w = self.data_shape
        mean = (ctypes.c_float * 3)(float(mean_b), float(mean_g),
                                    float(mean_r))     # BGR plane order
        std = (ctypes.c_float * 3)(float(std_b), float(std_g),
                                   float(std_r))
        self._handle = self._lib.mxt_loader_create(
            str(path_imgrec).encode(), int(batch_size), int(c), int(h),
            int(w), int(label_width), int(_parse_bool(shuffle)),
            int(_parse_bool(rand_crop)), int(_parse_bool(rand_mirror)),
            int(resize), float(scale), mean, std,
            int(preprocess_threads), int(seed) & 0xffffffff,
            int(part_index), int(num_parts))
        if not self._handle:
            raise MXNetError("cannot open record file %s" % path_imgrec)
        if self.layout == "NHWC":
            self._lib.mxt_loader_set_layout(self._handle, 1)
        self.num_samples = int(self._lib.mxt_loader_count(self._handle))

    @property
    def _batch_data_shape(self):
        c, h, w = self.data_shape
        if self.layout == "NHWC":
            return (self.batch_size, h, w, c)
        return (self.batch_size, c, h, w)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, self._batch_data_shape,
                         self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def failures(self):
        """Records that failed to read or decode so far (zero-filled in
        their batch, as the reference's parser skips them)."""
        return int(self._lib.mxt_loader_failures(self._handle))

    def reset(self):
        self._lib.mxt_loader_reset(self._handle)

    def next(self):
        import ctypes
        data = np.empty(self._batch_data_shape, self.dtype)
        label = np.empty((self.batch_size, self.label_width), np.float32)
        fill = self._lib.mxt_loader_next_u8 if self.dtype == np.uint8 \
            else self._lib.mxt_loader_next
        ptype = ctypes.c_uint8 if self.dtype == np.uint8 else ctypes.c_float
        fresh = fill(self._handle,
                     data.ctypes.data_as(ctypes.POINTER(ptype)),
                     label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if fresh <= 0:
            raise StopIteration
        if self.label_width == 1:
            label = label.reshape(self.batch_size)
        if self.output == "numpy":
            return DataBatch(data=[data], label=[label],
                             pad=self.batch_size - fresh)
        return DataBatch(data=[array(data)], label=[array(label)],
                         pad=self.batch_size - fresh)

    def iter_next(self):
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def getindex(self):
        return None

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mxt_loader_free(self._handle)
                self._handle = None
        except Exception:                   # noqa: BLE001
            pass


# options only the Python iterator has, with their defaults: one at
# another value selects the Python iterator (the native loader has no
# such augment)
_PY_ONLY_DEFAULTS = {"mean_img": None, "max_random_scale": 1.0,
                     "min_random_scale": 1.0, "max_rotate_angle": 0,
                     "max_aspect_ratio": 0.0, "random_h": 0,
                     "random_s": 0, "random_l": 0, "round_batch": True,
                     "preprocess_mode": "thread", "decode_workers": None}

# the Python class's leading positional parameters, made keywords so both
# backends see the same named arguments
_IRI_POSITIONAL = ("path_imgrec", "data_shape", "batch_size", "path_imgidx",
                   "label_width", "shuffle")


def ImageRecordIter(*args, **kwargs):
    """Factory (reference ``MXNET_REGISTER_IO_ITER(ImageRecordIter)``):
    the native loader unless an option only the Python iterator has is
    set, as the JAX package chooses.  ``backend="native"`` or
    ``"python"`` forces one.  Unlike the JAX package's, a native loader
    that cannot be built raises instead of falling back to Python."""
    backend = kwargs.pop("backend", "auto")
    if backend not in ("auto", "native", "python"):
        raise MXNetError("backend must be auto, native or python, got %r"
                         % (backend,))
    for name_, value in zip(_IRI_POSITIONAL, args):
        if name_ in kwargs:
            raise TypeError("ImageRecordIter got multiple values for %r"
                            % name_)
        kwargs[name_] = value
    if len(args) > len(_IRI_POSITIONAL):
        raise TypeError("too many positional arguments")

    def _non_default(k):
        if k not in kwargs:
            return False
        v, d = kwargs[k], _PY_ONLY_DEFAULTS[k]
        try:
            return float(v) != float(d)
        except (TypeError, ValueError):
            return v != d

    py_only = sorted(k for k in _PY_ONLY_DEFAULTS if _non_default(k))
    if backend == "python" or (backend == "auto" and py_only):
        return PyImageRecordIter(**kwargs)
    if py_only:
        raise MXNetError("backend='native' has no %s: use the python "
                         "backend" % ", ".join(py_only))
    return NativeImageRecordIter(**kwargs)


ImageRecordIter_v1 = ImageRecordIter
