"""Sequence bucketing IO for RNN training (``mxnet_tpu/rnn/io.py``).

API parity with the reference rnn io module (``encode_sentences`` +
``BucketSentenceIter``, ``python/mxnet/rnn/io.py``): sentences are
assigned to buckets with one ``searchsorted`` pass and padded into a
single ``[rows, bucket_len]`` matrix per bucket; next-token labels are the
data matrix shifted one step left.  Batches carry ``bucket_key``, which
selects BucketingModule's bucket.  The shuffles draw from numpy's global
``np.random``, in the JAX package's order, so one seed gives the same
batches in both packages.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray
from ..base import Context, current_context
from ..io import DataBatch, DataDesc, DataIter


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to int-id sequences.  With ``vocab=None`` a
    fresh vocabulary is grown (``invalid_key`` pinned to
    ``invalid_label``); otherwise unknown tokens are an error.  Returns
    ``(encoded, vocab)``."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sent in sentences:
        row = []
        for tok in sent:
            code = vocab.get(tok)
            if code is None:
                assert grow, "Unknown token %s" % tok
                if next_id == invalid_label:
                    next_id += 1
                code = vocab[tok] = next_id
                next_id += 1
            row.append(code)
        encoded.append(row)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over variable-length id sequences.

    Each batch is drawn from one bucket (all rows padded to that
    bucket's length with ``invalid_label``) and tagged with
    ``bucket_key``.  ``layout`` "NTC" yields batch-major arrays, "TNC"
    time-major.  Every epoch's bucket matrices go, whole, to the context
    that was current when the iterator was made (``gpu(0)`` unless a
    ``with mt.cpu():`` scope says otherwise), as ``NDArrayIter``'s arrays
    do; a batch is a view of them.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NTC"):
        super().__init__()
        lengths = np.fromiter((len(s) for s in sentences), dtype=np.int64,
                              count=len(sentences))
        if not buckets:
            hist = np.bincount(lengths)
            buckets = np.nonzero(hist >= batch_size)[0].tolist()
        buckets = sorted(buckets)
        assert buckets, "no buckets (every length rarer than batch_size?)"

        # one searchsorted pass: smallest bucket that fits each sentence
        edges = np.asarray(buckets)
        assignment = np.searchsorted(edges, lengths, side="left")

        self._store = []
        for b, blen in enumerate(buckets):
            rows = np.nonzero(assignment == b)[0]
            mat = np.full((rows.size, blen), invalid_label, dtype=dtype)
            for r, si in enumerate(rows):
                mat[r, :lengths[si]] = sentences[si]
            self._store.append(mat)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("layout %s must be batch-major (N first) or "
                             "time-major (N second)" % layout)
        self.default_bucket_key = max(buckets)
        # a copy: the current Context may be the one a caller's ``with``
        # has entered
        self.context = Context(current_context())

        shape = ((batch_size, self.default_bucket_key)
                 if self.major_axis == 0
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        # (bucket, row-offset) table of full batches
        self._batches = [(b, ofs)
                         for b, mat in enumerate(self._store)
                         for ofs in range(0, mat.shape[0] - batch_size + 1,
                                          batch_size)]
        self._order = np.arange(len(self._batches))
        self._cursor = 0
        self.reset()

    def reset(self):
        self._cursor = 0
        np.random.shuffle(self._order)
        self._device = []
        for mat in self._store:
            np.random.shuffle(mat)          # re-mix rows within the bucket
            pad_col = np.full((mat.shape[0], 1), self.invalid_label,
                              dtype=mat.dtype)
            labels = np.concatenate([mat[:, 1:], pad_col], axis=1)
            self._device.append(
                (ndarray.array(mat, ctx=self.context, dtype=self.dtype),
                 ndarray.array(labels, ctx=self.context, dtype=self.dtype)))

    def next(self):
        if self._cursor >= len(self._batches):
            raise StopIteration
        bucket, ofs = self._batches[self._order[self._cursor]]
        self._cursor += 1
        rows = slice(ofs, ofs + self.batch_size)
        dat, lab = self._device[bucket]
        if self.major_axis == 1:
            dat = ndarray.NDArray(dat.data[rows].T)
            lab = ndarray.NDArray(lab.data[rows].T)
        else:
            dat, lab = dat[rows], lab[rows]
        return DataBatch(
            [dat], [lab], pad=0, bucket_key=self.buckets[bucket],
            provide_data=[DataDesc(self.data_name, dat.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, lab.shape,
                                    layout=self.layout)])
