"""Data iterators (``mxnet_tpu/io.py``): :class:`DataDesc`,
:class:`DataBatch`, the :class:`DataIter` protocol and
:class:`NDArrayIter` over in-memory arrays (reference
``python/mxnet/io.py:19-610``).  The arrays live on the current context
(the card unless a ``with mx.cpu():`` scope says otherwise); a batch is
a view of them.  Shuffling draws from
:func:`mxnet_tpu_torch.random.np_rng`, as the JAX package's does, so one
seed gives the same order in both packages.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .ndarray import NDArray, array
from . import random as _random

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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
        return self.next()

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
