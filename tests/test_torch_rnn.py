"""The port's ``mt.rnn`` against ``mxnet_tpu.rnn``: every cell class
unrolled in both layouts through both packages' executors (the same
numpy parameters and inputs; outputs, final states and every gradient),
``encode_sentences``, ``BucketSentenceIter``'s batches for one
``np.random`` seed, and RNN checkpoints crossing packages both ways.
Tolerances: REL below (float32 sums in another order); bitwise where
no arithmetic happens."""
import os
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

# float32 on both sides, a few products a step summed in another order:
# every element within REL of the largest magnitude of its array
REL = 1e-5
T, N, I, H = 3, 2, 5, 6


def assert_close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, "%s: max error %.3g of the array's scale" % (what, err)


def _cells(pkg, kind):
    """The cell of one kind, built from package ``pkg`` (mx or mt)."""
    rnn = pkg.rnn
    if kind == "rnn_tanh":
        return rnn.RNNCell(H, prefix="rnn_")
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu", prefix="rnn_")
    if kind == "lstm":
        return rnn.LSTMCell(H, prefix="lstm_", forget_bias=0.5)
    if kind == "gru":
        return rnn.GRUCell(H, prefix="gru_")
    if kind == "fused_lstm_bi":
        return rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                bidirectional=True, prefix="f_")
    if kind == "fused_gru":
        return rnn.FusedRNNCell(H, num_layers=2, mode="gru", prefix="g_")
    if kind == "sequential":
        stack = rnn.SequentialRNNCell()
        stack.add(rnn.LSTMCell(H, prefix="s0_"))
        stack.add(rnn.DropoutCell(0.0, prefix="sd_"))
        stack.add(rnn.GRUCell(H, prefix="s1_"))
        return stack
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(I, prefix="res_"))
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="bl_"),
                                     rnn.RNNCell(H, prefix="br_"),
                                     output_prefix="bo_")
    if kind == "dropout":
        stack = rnn.SequentialRNNCell()
        stack.add(rnn.RNNCell(H, prefix="d0_"))
        stack.add(rnn.DropoutCell(0.5, prefix="dd_"))
        return stack
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(H, prefix="z_"),
                               zoneout_outputs=0.3, zoneout_states=0.4)
    raise ValueError(kind)


TRAINED = ["rnn_tanh", "rnn_relu", "lstm", "gru", "fused_lstm_bi",
           "fused_gru", "sequential", "residual", "bidirectional"]
# Dropout and zoneout masks come from each package's own generator, so
# those two are held to the JAX package in inference, where they pass
# values through
INFERENCE_ONLY = ["dropout", "zoneout"]


def _unrolled(pkg, kind, layout):
    with pkg.name.NameManager():
        cell = _cells(pkg, kind)
        outputs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                      layout=layout, merge_outputs=True)
        return cell, pkg.sym.Group([outputs] + list(states))


def _run(pkg, sym, ctx, values, cots, is_train):
    shapes = {"data": values["data"].shape}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the JAX package's graph lint
        exe = sym.simple_bind(ctx, **shapes)
    for name, arr in exe.arg_dict.items():
        arr[:] = values[name]
    outs = exe.forward(is_train=is_train)
    outs = [o.asnumpy() for o in outs]
    if not is_train:
        return outs, {}
    exe.backward([pkg.nd.array(c, ctx=ctx) for c in cots])
    return outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()
                  if g is not None}


def _values(sym, layout, seed=0):
    rng = np.random.RandomState(seed)
    data_shape = (N, T, I) if layout == "NTC" else (T, N, I)
    args, outs, _ = sym.infer_shape(data=data_shape)
    values = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), args)}
    cots = [rng.normal(0, 1, s).astype(np.float32) for s in outs]
    return values, cots


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", TRAINED + INFERENCE_ONLY)
def test_cell_unroll_matches_mxnet_tpu(kind, layout):
    _, jsym = _unrolled(mx, kind, layout)
    _, tsym = _unrolled(mt, kind, layout)
    # the same variables, letter for letter: parameter files cross
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    values, cots = _values(tsym, layout)
    train = kind in TRAINED
    jouts, jgrads = _run(mx, jsym, mx.cpu(), values, cots, train)
    touts, tgrads = _run(mt, tsym, mt.cpu(), values, cots, train)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert_close(t, j, what="output %d" % i)
    assert sorted(tgrads) == sorted(jgrads)
    for name in jgrads:
        assert_close(tgrads[name], jgrads[name], what="d" + name)


def test_lstm_bias_initializer_matches_mxnet_tpu():
    """``LSTMCell`` puts ``LSTMBias`` on its ``i2h_bias`` variable; any
    initializer then gives the forget quarter ``forget_bias``."""
    _, tsym = _unrolled(mt, "lstm", "NTC")
    _, jsym = _unrolled(mx, "lstm", "NTC")
    tattr = tsym.attr_dict()["lstm_i2h_bias"]["__init__"]
    assert tattr == jsym.attr_dict()["lstm_i2h_bias"]["__init__"]
    with mt.cpu():
        arr = mt.nd.zeros((4 * H,))
    mt.init.Xavier()(mt.init.InitDesc("lstm_i2h_bias",
                                      {"__init__": tattr}), arr)
    jarr = mx.nd.zeros((4 * H,))
    mx.init.Xavier()(mx.init.InitDesc("lstm_i2h_bias",
                                      {"__init__": tattr}), jarr)
    np.testing.assert_array_equal(arr.asnumpy(), jarr.asnumpy())
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 0.5
    np.testing.assert_array_equal(arr.asnumpy(), want)


def test_dropout_and_zoneout_cells_train():
    """In training the masked cells draw from the port's generator: one
    seed gives one result, outputs stay finite and backward runs."""
    for kind in INFERENCE_ONLY:
        _, tsym = _unrolled(mt, kind, "NTC")
        values, cots = _values(tsym, "NTC")
        runs = []
        for _ in range(2):
            mt.random.seed(3)
            runs.append(_run(mt, tsym, mt.cpu(), values, cots, True))
        (o1, g1), (o2, g2) = runs
        for a, b in zip(o1, o2):
            np.testing.assert_array_equal(a, b)
            assert np.isfinite(a).all()
        assert all(np.isfinite(g).all() for g in g1.values())
        infer, _ = _run(mt, tsym, mt.cpu(), values, cots, False)
        assert any(not np.array_equal(a, b) for a, b in zip(o1, infer))


def test_stepping_a_fused_or_bidirectional_cell_raises():
    for kind in ("fused_gru", "bidirectional"):
        cell = _cells(mt, kind)
        with pytest.raises(mt.MXNetError, match="cannot be stepped"):
            cell(mt.sym.Variable("x"), cell.begin_state())


def test_encode_sentences_matches_mxnet_tpu():
    sents = [["a", "b", "c"], ["b", "d"], ["e", "a", "a", "f"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 0},
               {"invalid_label": 0, "start_label": 1}):
        got = mt.rnn.encode_sentences(sents, **kw)
        want = mx.rnn.encode_sentences(sents, **kw)
        assert got == want
        again = mt.rnn.encode_sentences([["f", "a"]], vocab=got[1], **kw)
        assert again == mx.rnn.encode_sentences([["f", "a"]],
                                                 vocab=want[1], **kw)
    with pytest.raises(AssertionError, match="Unknown token"):
        mt.rnn.encode_sentences([["zz"]], vocab={"a": 1})


def _sentences(n=120, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 30, size=rng.randint(1, 13)))
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_bucket_sentence_iter_matches_mxnet_tpu(layout):
    """One ``np.random`` seed gives the same batches, bucket keys and
    shapes in both packages, epoch after epoch; the port's arrays sit on
    the context current when the iterator was made."""
    def epochs(it):
        # values read at once: the JAX package's CPU arrays may alias the
        # host matrices that the next reset shuffles in place
        out = []
        for _ in range(2):
            out.append([(b.bucket_key, b.provide_data[0].shape,
                         b.data[0].asnumpy(), b.label[0].asnumpy(),
                         b.data[0]) for b in it])
            it.reset()
        return out

    sents = _sentences()
    np.random.seed(7)
    jit = mx.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8, 12],
                                    invalid_label=0, layout=layout)
    jbatches = epochs(jit)
    np.random.seed(7)
    with mt.cpu():
        tit = mt.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8, 12],
                                        invalid_label=0, layout=layout)
    tbatches = epochs(tit)
    assert tit.default_bucket_key == jit.default_bucket_key == 12
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    assert tit.provide_label[0].shape == jit.provide_label[0].shape
    for tepoch, jepoch in zip(tbatches, jbatches):
        assert len(tepoch) == len(jepoch) > 0
        for tb, jb in zip(tepoch, jepoch):
            assert tb[:2] == jb[:2]
            np.testing.assert_array_equal(tb[2], jb[2])
            np.testing.assert_array_equal(tb[3], jb[3])
            assert tb[4].context == mt.cpu()
            assert tb[4].dtype == torch.float32
    assert [b[0] for b in tbatches[0]] != [b[0] for b in tbatches[1]]


def test_bucket_sentence_iter_without_cuda_raises():
    """The default context is the card: without CUDA the iterator raises
    instead of leaving its arrays on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.rnn.BucketSentenceIter(_sentences(), 8, buckets=[4, 8, 12])


def _fused_args(pkg, ctx):
    """A 2-layer bidirectional fused LSTM's packed arguments from numpy."""
    cell = pkg.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                bidirectional=True, prefix="f_")
    outputs, _ = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                             merge_outputs=True)
    args, _, _ = outputs.infer_shape(data=(2, 3, 5))
    rng = np.random.RandomState(0)
    values = {n: rng.normal(0, 1, s).astype(np.float32)
              for n, s in zip(outputs.list_arguments(), args)
              if n != "data"}
    return cell, outputs, values, {n: pkg.nd.array(v, ctx=ctx)
                                   for n, v in values.items()}


def test_fused_cell_unpack_and_pack_match_mxnet_tpu():
    tcell, _, values, targs = _fused_args(mt, mt.cpu())
    jcell, _, _, jargs = _fused_args(mx, mx.cpu())
    tun, jun = tcell.unpack_weights(targs), jcell.unpack_weights(jargs)
    assert sorted(tun) == sorted(jun)
    assert "f_l0_i2h_f_weight" in tun and "f_r1_h2h_o_bias" in tun
    for n in jun:
        np.testing.assert_array_equal(tun[n].asnumpy(), jun[n].asnumpy())
    packed = tcell.pack_weights(tun)
    assert sorted(packed) == sorted(values)
    for n, v in values.items():
        np.testing.assert_array_equal(packed[n].asnumpy(), v)


@pytest.mark.parametrize("writer", ["mxnet_tpu", "mxnet_tpu_torch"])
def test_rnn_checkpoint_crosses_packages(tmp_path, writer):
    """``save_rnn_checkpoint`` of either package loads in the other.  Both
    keep the JAX package's direction: save packs per-gate weights into
    the cells' fused arrays (the file a Module loads), load unpacks them
    again (the reference's ``rnn.py`` goes the other way; ROADMAP's
    defects of the JAX package)."""
    tcell, tsym, values, targs = _fused_args(mt, mt.cpu())
    jcell, jsym, _, jargs = _fused_args(mx, mx.cpu())
    tgates, jgates = tcell.unpack_weights(targs), jcell.unpack_weights(jargs)
    prefix = str(tmp_path / "lm")
    if writer == "mxnet_tpu":
        mx.rnn.save_rnn_checkpoint(jcell, prefix, 3, jsym, jgates, {})
        sym, args, aux = mt.rnn.load_rnn_checkpoint(tcell, prefix, 3)
    else:
        mt.rnn.save_rnn_checkpoint([tcell], prefix, 3, tsym, tgates, {})
        sym, args, aux = mx.rnn.load_rnn_checkpoint([jcell], prefix, 3)
    assert sym.list_arguments() == tsym.list_arguments()
    assert sorted(args) == sorted(jgates) and aux == {}
    for n, v in jgates.items():
        np.testing.assert_array_equal(args[n].asnumpy(), v.asnumpy())
    # on disk: the fused arrays under the module's names
    _, on_disk, _ = mt.model.load_checkpoint(prefix, 3)
    assert sorted(on_disk) == sorted(values)
    for n, v in values.items():
        np.testing.assert_array_equal(on_disk[n].asnumpy(), v)


def test_do_rnn_checkpoint_saves_every_period(tmp_path):
    tcell, tsym, values, targs = _fused_args(mt, mt.cpu())
    gates = tcell.unpack_weights(targs)
    prefix = str(tmp_path / "cb")
    cb = mt.rnn.do_rnn_checkpoint(tcell, prefix, period=2)
    for epoch in range(4):
        cb(epoch, tsym, gates, {})
    assert sorted(os.listdir(tmp_path)) == [
        "cb-0002.params", "cb-0004.params", "cb-symbol.json"]
    _, args, _ = mt.rnn.load_rnn_checkpoint(tcell, prefix, 4)
    for n, v in gates.items():
        np.testing.assert_array_equal(args[n].asnumpy(), v.asnumpy())


def test_rnn_unroll_is_the_cell_unroll():
    with mt.name.NameManager():
        a, _ = mt.rnn.rnn_unroll(mt.rnn.GRUCell(4, prefix="u_"), 3,
                                 inputs=mt.sym.Variable("data"))
    with mt.name.NameManager():
        b, _ = mt.rnn.GRUCell(4, prefix="u_").unroll(
            3, inputs=mt.sym.Variable("data"))
    assert mt.sym.Group(a).tojson() == mt.sym.Group(b).tojson()
