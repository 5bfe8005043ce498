"""Executor-manager helpers (``mxnet_tpu/executor_manager.py``,
reference ``python/mxnet/executor_manager.py``).

``_split_input_slice`` splits a batch across a context list by work
load; ``_load_general`` copies each slice of a batch into its executor's
input array, on that executor's device.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """A batch split into slices proportional to ``work_load_list``
    (reference contract ``executor_manager.py:15-41``)."""
    total = sum(work_load_list)
    shares = [round(batch_size * w / total) for w in work_load_list]
    shortfall = batch_size - sum(shares)
    if shortfall > 0:
        shares[-1] += shortfall     # the rounding remainder goes last
    slices = []
    end = 0
    for share in shares:
        begin = int(min(end, batch_size))
        end = int(min(begin + share, batch_size))
        if begin >= end:
            raise MXNetError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """No duplicated argument or aux names
    (reference ``executor_manager.py:44-69``)."""
    arg_set = set()
    for name in symbol.list_arguments():
        if name in arg_set:
            raise ValueError("Find duplicated argument name \"%s\"" % name)
        arg_set.add(name)
    aux_set = set()
    for name in symbol.list_auxiliary_states():
        if name in aux_set:
            raise ValueError("Find duplicated auxiliary param name \"%s\""
                             % name)
        aux_set.add(name)


def _load_general(data, targets):
    """Copy each batch array into its targets (reference
    ``executor_manager.py:72-88``): a target NDArray takes the whole
    array; a list of ``(slice, NDArray)`` takes each slice, onto that
    array's device and dtype."""
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, NDArray):
            d_targets._set_data(d_src.data if isinstance(d_src, NDArray)
                                else np.asarray(d_src))
            continue
        src = d_src.data if isinstance(d_src, NDArray) else np.asarray(d_src)
        for slice_idx, d_dst in d_targets:
            piece = src[slice_idx]
            if tuple(piece.shape) != tuple(d_dst.shape):
                raise MXNetError(
                    "array shape do not match the shape of NDArray: "
                    "%s vs %s" % (tuple(piece.shape), tuple(d_dst.shape)))
            d_dst._set_data(piece)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup(object):
    """``module.executor_group.DataParallelExecutorGroup``, under its old
    name."""

    def __new__(cls, *args, **kwargs):
        from .module.executor_group import DataParallelExecutorGroup as G
        return G(*args, **kwargs)
