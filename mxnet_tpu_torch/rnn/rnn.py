"""RNN utility functions (``mxnet_tpu/rnn/rnn.py``; reference
``python/mxnet/rnn/rnn.py``): checkpoints with cell weights packed."""
from __future__ import annotations

from .. import model


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC"):
    """[Deprecated in the reference too] use ``cell.unroll`` instead."""
    return cell.unroll(length=length, inputs=inputs, begin_state=begin_state,
                       layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save with cell weights packed (reference ``rnn.py:15``)."""
    if isinstance(cells, (list, tuple)):
        for cell in cells:
            arg_params = cell.pack_weights(arg_params)
    else:
        arg_params = cells.pack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load with cell weights unpacked (reference ``rnn.py:45``)."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    if isinstance(cells, (list, tuple)):
        for cell in cells:
            arg = cell.unpack_weights(arg)
    else:
        arg = cells.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing RNN cells
    (reference ``rnn.py:80``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
