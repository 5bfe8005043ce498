"""Model-level helpers (``mxnet_tpu/model.py``): the KVStore decision,
the store-side and local parameter updates, and the checkpoint format.

Checkpoints use the reference's on-disk contract (``model.py:319-375``):
``prefix-symbol.json`` + ``prefix-%04d.params`` with ``arg:``/``aux:``
key prefixes, so a checkpoint saved by either package loads in the
other.
"""
from __future__ import annotations

import logging

import numpy as np

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint"]

# what a request for several devices names
KVSTORE_SLICE = ("training on several contexts is not ported yet: it comes "
                 "with the port's multi-device KVStore slice")


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store, update_on_kvstore)`` (reference ``model.py:40-68``).  One
    device with a local store needs none; a ``dist`` string or a store
    object gives a store that owns the update."""
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


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Checkpoint to ``prefix-symbol.json`` + ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays
    on the CPU."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
