"""RNN cell library (``mxnet_tpu/rnn``; reference ``python/mxnet/rnn/``):
cells, checkpoint helpers and the bucketing sentence iterator."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn import (rnn_unroll, save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
from .io import encode_sentences, BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell", "rnn_unroll",
           "save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint",
           "encode_sentences", "BucketSentenceIter"]
