"""``mt.mod.BucketingModule`` on the CPU: buckets share one parameter set
(one storage per parameter and per gradient), a bucket bound mid-training
starts from the current parameters, and a bucketed ``fit`` with SGD
momentum matches a reference that the JAX package's own executors,
optimizer and shared updater compute, the parameters carried from bucket
to bucket by the test (the JAX package's buckets do not share them:
ROADMAP's defects of the JAX package)."""
import logging
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.models  # noqa: F401  (the zoo is not imported by the package)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import params_from_mxnet_tpu

HIDDEN, EMBED, LAYERS, VOCAB, BATCH = 12, 10, 2, 30, 4
SGD = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}
# float32 on both sides: per parameter, |port - reference| over
# |reference| (Frobenius norms) after every step
REL_NORM = 1e-5


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _lm(pkg):
    return pkg.models.lstm_lm.sym_gen_factory(HIDDEN, EMBED, LAYERS, VOCAB)


def _batch(pkg, key, rng, ctx):
    data = rng.randint(1, VOCAB, (BATCH, key)).astype(np.float32)
    data[0, -2:] = 0                        # padding, as the iterator's
    label = np.concatenate([data[:, 1:], np.zeros((BATCH, 1), np.float32)],
                           axis=1)
    return pkg.io.DataBatch(
        [pkg.nd.array(data, ctx=ctx)], [pkg.nd.array(label, ctx=ctx)], pad=0,
        bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", (BATCH, key))],
        provide_label=[pkg.io.DataDesc("softmax_label", (BATCH, key))])


class _Batches(mt.io.DataIter):
    """A fixed list of batches, once an epoch."""

    def __init__(self, batches, default_key):
        super().__init__(BATCH)
        self.batches, self.i = batches, 0
        shape = (BATCH, default_key)
        self.provide_data = [mt.io.DataDesc("data", shape)]
        self.provide_label = [mt.io.DataDesc("softmax_label", shape)]

    def reset(self):
        self.i = 0

    def next(self):
        if self.i == len(self.batches):
            raise StopIteration
        self.i += 1
        return self.batches[self.i - 1]


def _initial_params(default_key, seed=0):
    sym, _, _ = _lm(mt)(default_key)
    args, _, _ = sym.infer_shape(data=(BATCH, default_key),
                                 softmax_label=(BATCH, default_key))
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), args)
            if n not in ("data", "softmax_label")}


def _bound(default_key=6, grad_req="write"):
    with mt.cpu():
        mod = mt.mod.BucketingModule(_lm(mt), default_bucket_key=default_key)
    mod.bind([("data", (BATCH, default_key))],
             [("softmax_label", (BATCH, default_key))], grad_req=grad_req)
    args = params_from_mxnet_tpu(_initial_params(default_key), {})[0]
    mod.init_params(arg_params={n: mt.nd.NDArray(v) for n, v in
                                args.items()}, aux_params={})
    return mod


def _exec(mod, key):
    return mod._buckets[key]._exec_group.execs[0]


def test_buckets_share_one_storage_per_parameter_and_gradient():
    mod = _bound()
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    rng = np.random.RandomState(0)
    for key in (6, 4, 5):
        mod.forward(_batch(mt, key, rng, mt.cpu()), is_train=True)
        mod.backward()
        mod.update()
    assert sorted(mod._buckets) == [4, 5, 6]
    default = _exec(mod, 6)
    names = mod._buckets[6]._param_names
    assert "pred_weight" in names and "lstm_l1_h2h_weight" in names
    for key in (4, 5):
        other = _exec(mod, key)
        for n in names:
            assert other.arg_dict[n] is default.arg_dict[n]
            assert other.grad_dict[n] is default.grad_dict[n]
            assert other.arg_dict[n].data.data_ptr() == \
                default.arg_dict[n].data.data_ptr()
        # what differs is bound anew: the inputs of the bucket's length
        assert other.arg_dict["data"].shape == (BATCH, key)
        assert other.arg_dict["data"] is not default.arg_dict["data"]
        # one host copy, one optimizer, one updater (momentum state)
        child = mod._buckets[key]
        assert child._arg_params is mod._buckets[6]._arg_params
        assert child._updater is mod._buckets[6]._updater
        # no bucket keeps its autograd graph past its backward
        assert other._graph is None


def test_a_bucket_bound_mid_training_starts_from_the_current_params():
    """The two faults the JAX package shows (ROADMAP): a new bucket
    starting from zeros, and an update in one bucket never reaching
    another.  Here both buckets read and write the one parameter set."""
    mod = _bound()
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    rng = np.random.RandomState(1)
    for _ in range(2):
        mod.forward(_batch(mt, 6, rng, mt.cpu()), is_train=True)
        mod.backward()
        mod.update()
    trained = _exec(mod, 6).arg_dict["pred_weight"].asnumpy()
    assert not np.allclose(trained, _initial_params(6)["pred_weight"])
    mod.forward(_batch(mt, 4, rng, mt.cpu()), is_train=True)
    np.testing.assert_array_equal(_exec(mod, 4).arg_dict["pred_weight"]
                                  .asnumpy(), trained)
    mod.backward()
    mod.update()
    after = _exec(mod, 6).arg_dict["pred_weight"].asnumpy()
    assert np.abs(after - trained).max() > 1e-4
    arg, _ = mod.get_params()
    np.testing.assert_array_equal(arg["pred_weight"].asnumpy(), after)


def test_grad_req_add_adds_into_the_one_gradient_array():
    rng = np.random.RandomState(2)
    b6, b4 = _batch(mt, 6, rng, mt.cpu()), _batch(mt, 4, rng, mt.cpu())
    alone = []
    for batch in (b6, b4):
        mod = _bound()
        mod.forward(batch, is_train=True)
        mod.backward()
        alone.append(_exec(mod, batch.bucket_key)
                     .grad_dict["pred_weight"].asnumpy())
    mod = _bound(grad_req="add")
    for batch in (b6, b4):
        mod.forward(batch, is_train=True)
        mod.backward()
    total = _exec(mod, 4).grad_dict["pred_weight"]
    assert total is _exec(mod, 6).grad_dict["pred_weight"]
    np.testing.assert_allclose(total.asnumpy(), alone[0] + alone[1],
                               rtol=1e-6, atol=1e-7)


def _jax_reference(batches, init, default_key):
    """The JAX package's BucketingModule stepping ``batches``, the
    parameters carried by the test: before each batch they are written
    into the bucket's executor, after its update read back, so the JAX
    package's own executors, SGD and shared updater do the arithmetic.
    Returns (params after each step, Perplexity at the end)."""
    jmod = mx.mod.BucketingModule(_lm(mx), default_bucket_key=default_key,
                                  context=mx.cpu())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the JAX package's graph lint
        jmod.bind([("data", (BATCH, default_key))],
                  [("softmax_label", (BATCH, default_key))])
        jmod.init_params(arg_params={n: mx.nd.array(v)
                                     for n, v in init.items()},
                         aux_params={})
        jmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    carried = dict(init)
    metric = mx.metric.Perplexity(0)
    steps = []
    for batch in batches:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmod.switch_bucket(batch.bucket_key, batch.provide_data,
                               batch.provide_label)
        group = jmod._active._exec_group
        group.set_params({n: mx.nd.array(v) for n, v in carried.items()},
                         {})
        jmod.forward(batch, is_train=True)
        jmod.backward()
        jmod.update()
        jmod.update_metric(metric, batch.label)
        carried = {n: group.execs[0].arg_dict[n].asnumpy() for n in carried}
        steps.append(carried)
    return steps, metric.get()[1]


def test_bucketed_fit_matches_the_jax_built_reference():
    keys = [6, 4, 6, 5]
    default_key = max(keys)
    init = _initial_params(default_key)
    rng = np.random.RandomState(3)
    feed = [rng.randint(0, 2 ** 31) for _ in keys]
    jbatches = [_batch(mx, k, np.random.RandomState(s), mx.cpu())
                for k, s in zip(keys, feed)]
    tbatches = [_batch(mt, k, np.random.RandomState(s), mt.cpu())
                for k, s in zip(keys, feed)]
    want, want_ppl = _jax_reference(jbatches, init, default_key)

    with mt.cpu():
        mod = mt.mod.BucketingModule(_lm(mt), default_bucket_key=default_key)
    steps = []

    def record(param):
        steps.append({n: a.asnumpy() for n, a in
                      _exec(mod, mod._active_key).arg_dict.items()
                      if n in init})

    metric = mt.metric.Perplexity(0)
    args = params_from_mxnet_tpu(init, {})[0]
    mod.fit(_Batches(tbatches, default_key), eval_metric=metric,
            num_epoch=1, optimizer="sgd", optimizer_params=SGD,
            kvstore="device", batch_end_callback=record,
            arg_params={n: mt.nd.NDArray(v) for n, v in args.items()},
            aux_params={})
    assert sorted(mod._buckets) == sorted(set(keys))
    assert len(steps) == len(want) == len(keys)
    for i, (got, ref) in enumerate(zip(steps, want)):
        for n in init:
            err = _rel_norm(got[n], ref[n])
            assert err <= REL_NORM, (i, n, err)
    assert abs(metric.get()[1] - want_ppl) <= REL_NORM * want_ppl
    final, _ = mod.get_params()
    for n in init:
        assert _rel_norm(final[n].asnumpy(), want[-1][n]) <= REL_NORM


def test_lstm_lm_trains_from_a_bucket_sentence_iter_on_the_cpu():
    """The example's path end to end at small widths: encode, bucket,
    ``fit`` with Perplexity(0), Xavier and LSTMBias, SGD, a ``device``
    store; every bucket bound, one parameter set, perplexity falling,
    and ``score`` running over the same buckets."""
    rng = np.random.RandomState(0)
    sents = []
    for _ in range(240):
        length = int(rng.choice([4, 8, 12])) - rng.randint(0, 3)
        state = rng.randint(1, VOCAB)
        sent = []
        for _ in range(length):
            state = (state * 7 + rng.randint(0, 2)) % VOCAB
            sent.append(max(state, 1))
        sents.append(sent)
    np.random.seed(0)
    mt.random.seed(0)
    with mt.cpu():
        it = mt.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8, 12],
                                       invalid_label=0)
        mod = mt.mod.BucketingModule(_lm(mt),
                                     default_bucket_key=it.default_bucket_key)
    per_epoch = []
    mod.fit(it, eval_metric=mt.metric.Perplexity(0), num_epoch=6,
            optimizer="sgd", optimizer_params={"learning_rate": 0.05,
                                               "momentum": 0.9},
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            kvstore="device",
            epoch_end_callback=lambda e, s, a, x: per_epoch.append(
                mod.score(it, mt.metric.Perplexity(0))[0][1]))
    assert sorted(mod._buckets) == [4, 8, 12]
    assert per_epoch[-1] < 0.5 * per_epoch[0], per_epoch
    forget = _exec(mod, 12).arg_dict["lstm_l0_i2h_bias"].asnumpy()
    assert forget.shape == (4 * HIDDEN,)
    for key in (4, 8):
        assert _exec(mod, key).arg_dict["pred_weight"] is \
            _exec(mod, 12).arg_dict["pred_weight"]


def test_module_shared_bind_and_borrow_optimizer():
    """``Module.bind(shared_module=...)`` takes the classic path even
    where the fused one would run, shares the arrays and host copies,
    and borrows the shared module's optimizer."""
    sym6, _, _ = _lm(mt)(6)
    sym4, _, _ = _lm(mt)(4)
    with mt.cpu():
        first = mt.mod.Module(sym6)
        first._fused_mode = "never"
        first.bind([("data", (BATCH, 6))], [("softmax_label", (BATCH, 6))])
        first.init_params(mt.init.Xavier())
        first.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        second = mt.mod.Module(sym4)
        second._fused_mode = "always"
        second.bind([("data", (BATCH, 4))], [("softmax_label", (BATCH, 4))],
                    shared_module=first)
    assert not second._fused and second._exec_group is not None
    assert second.params_initialized and second.optimizer_initialized
    assert second._updater is first._updater
    assert second._arg_params is first._arg_params
    e1, e2 = first._exec_group.execs[0], second._exec_group.execs[0]
    assert e2.arg_dict["embed_weight"] is e1.arg_dict["embed_weight"]
    with mt.cpu():
        fused = mt.mod.Module(sym6)
        fused._fused_mode = "always"
        fused.bind([("data", (BATCH, 6))], [("softmax_label", (BATCH, 6))])
        fused.init_params()
        with pytest.raises(mt.MXNetError, match="classic path"):
            mt.mod.Module(sym4).bind([("data", (BATCH, 4))],
                                     [("softmax_label", (BATCH, 4))],
                                     shared_module=fused)


def test_install_monitor_names_its_slice_and_the_context_is_kept():
    with mt.cpu():
        mod = mt.mod.BucketingModule(_lm(mt), default_bucket_key=6,
                                     logger=logging)
    # made under ``with mt.cpu()``: every bucket binds there, later too
    mod.bind([("data", (BATCH, 6))], [("softmax_label", (BATCH, 6))])
    assert _exec(mod, 6).arg_dict["pred_weight"].context == mt.cpu()
    # the monitor is ported: it lands on the bound bucket's executor
    mon = mt.monitor.Monitor(1)
    mod.install_monitor(mon)
    assert mon._executors == [_exec(mod, 6)]
    with pytest.raises(mt.MXNetError, match="not supported"):
        mt.mod.BucketingModule(_lm(mt), default_bucket_key=6,
                               context=mt.cpu()).bind(
            [("data", (BATCH, 6))], shared_module=mod)


def test_rnn_op_symbol_binds_and_its_params_cross_through_convert():
    """A symbol over the fused ``RNN`` op: its flat parameter vector and
    states cross from the JAX package through ``convert`` unchanged, and
    the executor's outputs and gradients match the JAX executor's."""
    def build(pkg):
        with pkg.name.NameManager():
            data = pkg.sym.Variable("data")
            out = pkg.sym.RNN(data, state_size=7, num_layers=2, mode="lstm",
                              bidirectional=True, name="rnn")
            return pkg.sym.Reshape(out, shape=(-1, 14))
    jsym, tsym = build(mx), build(mt)
    assert tsym.list_arguments() == jsym.list_arguments() == [
        "data", "rnn_parameters", "rnn_state", "rnn_state_cell"]
    shapes = dict(data=(5, 3, 4))
    args, outs, _ = tsym.infer_shape(**shapes)
    assert (args, outs) == tuple(jsym.infer_shape(**shapes)[:2])
    rng = np.random.RandomState(0)
    values = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(tsym.list_arguments(), args)}
    cot = rng.normal(0, 1, outs[0]).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jexe = jsym.simple_bind(mx.cpu(), **shapes)
    for n, v in values.items():
        jexe.arg_dict[n][:] = v
    jout = jexe.forward(is_train=True)[0].asnumpy()
    jexe.backward([mx.nd.array(cot)])
    crossed = params_from_mxnet_tpu(
        {n: a.asnumpy() for n, a in jexe.arg_dict.items()}, {})[0]
    texe = tsym.simple_bind(mt.cpu(), **shapes)
    for n, v in crossed.items():
        assert torch.equal(v, torch.from_numpy(values[n]))
        texe.arg_dict[n][:] = v
    tout = texe.forward(is_train=True)[0].asnumpy()
    texe.backward([mt.nd.array(cot, ctx=mt.cpu())])
    for got, want in [(tout, jout)] + [
            (texe.grad_dict[n].asnumpy(), jexe.grad_dict[n].asnumpy())
            for n in values]:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale


def test_lstm_lm_is_in_the_zoo():
    with mt.name.NameManager():
        sym = mt.models.get_symbol("lstm_lm", num_classes=40, seq_len=5,
                                   num_hidden=8, num_embed=6)
    with mt.name.NameManager():
        want, _, _ = mt.models.lstm_lm.sym_gen_factory(8, 6, 2, 40)(5)
    assert sym.tojson() == want.tojson()
    jsym = mx.models.lstm_lm.get_symbol(seq_len=5, num_classes=40,
                                        num_hidden=8, num_embed=6)
    assert sym.list_arguments() == jsym.list_arguments()
