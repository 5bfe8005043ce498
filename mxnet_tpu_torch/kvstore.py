"""KVStore (``mxnet_tpu/kvstore.py``): the parameter-synchronisation
facade.

Reference: ``include/mxnet/kvstore.h:26-303`` + ``src/kvstore/``.  The
``local``/``device`` stores merge the values pushed for a key (one sum on
the first value's device, the counterpart of ``CommDevice::Reduce``) and
either keep the sum or hand it to the updater.  The ``dist_sync`` stores
(``dist_sync``, ``dist_sync_tpu``, ``dist_sync_device``,
``dist_device_sync``, ``dist``) are :class:`KVStoreTPU`: every worker
process of the ``torch.distributed`` group (joined at import from the
launcher's ``MXTPU_*`` variables) is a rank; ``init`` takes rank 0's
value, and a push sums the local values and then all-reduces the sum
over the ranks, so every rank applies the same update (the sync-mode
contract of ``kvstore_dist_server.h:164-210``, with no server role).
Alone it is rank 0 of one worker.  ``dist_async`` raises, as in the JAX
package.

The Python surface (init/push/pull/set_optimizer/_set_updater/_barrier,
``save_optimizer_states``) mirrors ``python/mxnet/kvstore.py``.
"""
from __future__ import annotations

from . import health as _health
from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray
from .parallel import collectives as _coll

__all__ = ["KVStore", "KVStoreTPU", "create"]

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
                if self._stored[k].data.device != merged.data.device:
                    # the value moves, once, to where the gradients are
                    # summed, and the updater runs there
                    self._stored[k] = NDArray(
                        self._stored[k].data.to(merged.data.device))
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
    """The ``dist_sync`` stores over the worker processes of the
    ``torch.distributed`` group (``rank``/``num_workers`` from it; rank 0
    of one worker without it).  Made with a heartbeat directory
    (``MXTPU_HEARTBEAT_DIR``) or a process group, it stamps this rank's
    liveness (``health.Heartbeat``)."""

    def __init__(self, kind):
        super().__init__(kind)
        self._heartbeat = _health.Heartbeat(self.rank)

    @property
    def rank(self):
        return _coll._process_index()

    @property
    def num_workers(self):
        return _coll._process_count()

    def init(self, key, value):
        """Rank 0's value wins (reference ``kvstore_dist.h:63-80``: only
        rank 0 pushes the init; every rank pulls it back), so ranks whose
        initialisers drew different numbers start alike."""
        keys, single = _key_list(key)
        for k, vlist in zip(keys, _val_list_list(value, single)):
            if k in self._stored:
                continue
            v = vlist[0]
            if self.num_workers > 1:
                v = NDArray(_coll.broadcast_from_rank0(v.data))
            self._stored[k] = v.copy()

    def _merge(self, vlist):
        """The local add-n, then its sum over every rank (one all-reduce
        a key, outside any step; Module's fused path sums inside its
        step instead)."""
        merged = super()._merge(vlist)
        if self.num_workers > 1:
            merged = NDArray(_coll.global_allreduce(merged.data))
        return merged

    def num_dead_node(self, node_id=0, timeout=60):
        """Ranks whose liveness stamps lapsed (reference
        ``get_num_dead_node``; ``health.dead_nodes``)."""
        return len(_health.dead_nodes(self.num_workers, timeout=timeout))

    def save_optimizer_states(self, fname):
        """The updater's state, identical on every rank, committed by rank
        0 through ``model._commit_file`` (tmp, fsync, rename) with
        ``resilience.retry_io``; another rank raises (the reference
        refuses a dist save: its state lived on the servers).  No
        implicit barrier: a job whose other ranks load right after orders
        the two with ``kv._barrier()``."""
        if self._updater is None:
            raise MXNetError("no optimizer state to save: call "
                             "set_optimizer first")
        if self.rank != 0:
            raise MXNetError(
                "dist optimizer-state saves are rank-0-only (one copy "
                "of truth, identical on every rank); guard the "
                "checkpoint call with kv.rank == 0")
        from .model import _commit_file
        from .resilience import retry_io
        blob = self._updater.get_states()

        def write(tmp):
            with open(tmp, "wb") as f:
                f.write(blob)

        retry_io(lambda: _commit_file(fname, write,
                                      crash_site="ckpt_write"),
                 what="dist optimizer state write")

    def load_optimizer_states(self, fname):
        """Restore the rank-0-written state on this rank (reads retried;
        no implicit barrier)."""
        if self._updater is None:
            raise MXNetError("no optimizer state to load: call "
                             "set_optimizer first")
        from .resilience import retry_io

        def read():
            with open(fname, "rb") as f:
                return f.read()

        self._updater.set_states(retry_io(read,
                                          what="dist optimizer state read"))

    def _barrier(self):
        if self.num_workers > 1:
            _coll.barrier()


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
