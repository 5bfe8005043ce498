"""Model-level helpers (``mxnet_tpu/model.py``): the one-device store
decision, the local parameter update, and the checkpoint format.

Checkpoints use the reference's on-disk contract (``model.py:319-375``):
``prefix-symbol.json`` + ``prefix-%04d.params`` with ``arg:``/``aux:``
key prefixes, so a checkpoint saved by either package loads in the
other.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint"]

# what a request the port cannot honour yet names
KVSTORE_SLICE = ("KVStore (multi-device and dist kvstores) is not ported "
                 "yet: it comes with the port's KVStore slice")


def _create_kvstore(kvstore, num_device):
    """``(store, update_on_kvstore)`` (reference ``model.py:40-68``).  One
    device with a local store needs none, as in the reference; anything
    else needs the KVStore slice and raises."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore:
        return None, False
    raise MXNetError("kvstore %r on %d device(s): %s"
                     % (kvstore, num_device, KVSTORE_SLICE))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Local-updater path (reference ``model.py:99-116``): the updater
    on each device copy under the reference's ``index * num_device +
    device`` state keys; frozen parameters (gradient slot None) are
    skipped."""
    if kvstore is not None:
        raise MXNetError(KVSTORE_SLICE)
    for idx, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is None:
            continue
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
