"""KVStore (``mxnet_tpu/kvstore.py``): the parameter-synchronisation
facade, in one process.

Reference: ``include/mxnet/kvstore.h:26-303`` + ``src/kvstore/``.  The
``local``/``device`` stores merge the values pushed for a key (one sum on
the first value's device, the counterpart of ``CommDevice::Reduce``) and
either keep the sum or hand it to the updater.  The ``dist_sync`` stores
(``dist_sync``, ``dist_sync_tpu``, ``dist_sync_device``,
``dist_device_sync``, ``dist``) run as the JAX package's ``KVStoreTPU``
runs alone: rank 0 of one worker, with local semantics.  Several
processes (``torch.distributed`` initialised with more than one) wait for
the port's multi-process KVStore and raise.  ``dist_async`` raises, as in
the JAX package.

The Python surface (init/push/pull/set_optimizer/_set_updater/_barrier,
``save_optimizer_states``) mirrors ``python/mxnet/kvstore.py``.
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "KVStoreTPU", "create"]

# what a multi-process store names
MULTI_PROCESS = ("a dist KVStore over several processes waits for the "
                 "port's multi-process KVStore (ROADMAP item 5)")


def _key_list(key):
    if isinstance(key, (str, int)):
        return [key], True
    return list(key), False


def _val_list_list(vals, single_key):
    """Normalise to a list, per key, of the values pushed for it."""
    if single_key:
        if isinstance(vals, NDArray):
            return [[vals]]
        return [list(vals) if isinstance(vals, (list, tuple)) else [vals]]
    return [[v] if isinstance(v, NDArray) else list(v) for v in vals]


def _updater_key(k):
    """Reference updaters receive int keys; Module uses str: pass through."""
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStore(object):
    """In-process key-value store (``mxnet_tpu/kvstore.py:57``)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._stored = {}
        self._updater = None
        self._optimizer = None

    def init(self, key, value):
        """Initialise keys; a key already initialised keeps its value."""
        keys, single = _key_list(key)
        for k, vlist in zip(keys, _val_list_list(value, single)):
            if k not in self._stored:
                self._stored[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Merge the values pushed for each key; with an updater, apply it
        to the stored value, else the merge replaces it (reference
        ``kvstore_local.h:69-71``)."""
        keys, single = _key_list(key)
        for k, vlist in zip(keys, _val_list_list(value, single)):
            if k not in self._stored:
                raise MXNetError("key %s not initialized" % str(k))
            merged = self._merge(vlist)
            if self._updater is not None:
                self._updater(_updater_key(k), merged, self._stored[k])
            else:
                self._stored[k] = merged

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into every ``out`` array, onto
        its device and dtype."""
        assert out is not None
        keys, single = _key_list(key)
        for k, olist in zip(keys, _val_list_list(out, single)):
            if k not in self._stored:
                raise MXNetError("key %s not initialized" % str(k))
            src = self._stored[k].data
            for o in olist:
                o._set_data(src)

    def _merge(self, vlist):
        """The sum of the values pushed from N devices, on the first's
        device: a fresh array."""
        acc = vlist[0].data.clone()
        for v in vlist[1:]:
            acc += v.data.to(acc.device)
        return NDArray(acc)

    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` to every push (the reference pickles it to
        the servers; with no server it runs here)."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def num_dead_node(self, node_id=0, timeout=60):
        """Peers whose liveness lapsed: a single process has none."""
        return 0

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        pass

    def _send_command_to_servers(self, head, body):
        pass


class KVStoreTPU(KVStore):
    """The ``dist_sync`` stores, one process: rank 0 of one worker, local
    semantics (the JAX package's ``KVStoreTPU`` alone).  Made while
    ``torch.distributed`` runs several processes, it raises."""

    def __init__(self, kind):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise MXNetError("kvstore %r over %d processes: %s"
                             % (kind, dist.get_world_size(), MULTI_PROCESS))
        super().__init__(kind)


def create(name="local"):
    """Create a KVStore (reference ``kvstore.py:379``; factory strings
    ``src/kvstore/kvstore.cc:17-45``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    kind = name.lower()
    if kind in ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device"):
        return KVStore(kind)
    if kind in ("dist_sync", "dist_sync_tpu", "dist_sync_device",
                "dist_device_sync", "dist"):
        return KVStoreTPU(kind)
    if kind.startswith("dist_async"):
        raise MXNetError(
            "dist_async has no TPU analog: XLA collectives are bulk-"
            "synchronous over ICI. Use dist_sync_tpu (allreduce) instead.")
    raise MXNetError("unknown kvstore type %s" % name)
