"""Bucketing LSTM language model (``mxnet_tpu/models/lstm_lm.py``), the
reference's ``example/rnn/lstm_bucketing.py`` network: embed -> stacked
LSTM unroll -> per-step FC -> softmax over the vocabulary.

:func:`sym_gen_factory` returns the ``sym_gen(seq_len)`` closure that
:class:`~mxnet_tpu_torch.module.BucketingModule` calls once per bucket
length; every bucket's symbol names its parameters alike, so the buckets
share one parameter set.
"""
from .. import symbol as sym
from .. import rnn as _rnn


def sym_gen_factory(num_hidden=200, num_embed=200, num_layers=2,
                    vocab_size=10000, dropout=0.0):
    """Build the ``sym_gen`` callable used by BucketingModule."""

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        stack = _rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(_rnn.LSTMCell(num_hidden=num_hidden,
                                    prefix="lstm_l%d_" % i))
            if dropout > 0:
                stack.add(_rnn.DropoutCell(dropout, prefix="drop_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                  merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                  name="pred")
        lab = sym.Reshape(label, shape=(-1,))
        out = sym.SoftmaxOutput(data=pred, label=lab, name="softmax")
        return out, ("data",), ("softmax_label",)

    return sym_gen


def get_symbol(seq_len=35, num_classes=10000, **kwargs):
    """Fixed-length variant (no bucketing) for benchmarks/tests."""
    kwargs.setdefault("vocab_size", num_classes)
    out, _, _ = sym_gen_factory(**kwargs)(seq_len)
    return out
