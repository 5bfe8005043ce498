"""The port's Module on the CPU: the analogs of ``tests/test_module.py``
and of ``tests/test_models.py::test_transformer_lm_learns``, and
checkpoints that load in both packages."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.module import Module as JaxModule

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import Module

# a checkpoint loaded by the other package gives the same forward: float32
# products of the same weights in another order
FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)


def _softmax_mlp(m, nh=16, nout=2):
    data = m.sym.Variable("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=nh, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu")
    fc2 = m.sym.FullyConnected(act, num_hidden=nout, name="fc2")
    return m.sym.SoftmaxOutput(fc2, name="softmax")


def _toy(n=200, d=10, k=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype("f")
    w = rng.randn(d, k).astype("f")
    return x, np.argmax(x @ w, axis=1).astype("f")


def _port_iter(batch=20):
    with mt.cpu():
        return mt.io.NDArrayIter(*_toy(), batch_size=batch, shuffle=False)


def test_module_train_acc():
    train = _port_iter()
    mod = Module(_softmax_mlp(mt), context=mt.cpu())
    mod.fit(train, num_epoch=5, optimizer_params={"learning_rate": 0.5},
            initializer=mt.init.Xavier())
    train.reset()
    assert mod.score(train, "acc")[0][1] > 0.9
    assert mod.predict(train).shape == (200, 2)
    assert mod.output_shapes == [("softmax_output", (20, 2))]


def test_module_input_grads_and_forward_shapes():
    mod = Module(_softmax_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))],
             for_training=True, inputs_need_grad=True)
    mod.init_params()
    batch = mt.io.DataBatch(data=[mt.nd.ones((4, 10), ctx=mt.cpu())],
                            label=[mt.nd.zeros((4,), ctx=mt.cpu())], pad=0)
    mod.forward(batch, is_train=True)
    mod.backward()
    assert mod.get_outputs()[0].shape == (4, 2)
    grads = mod.get_input_grads()
    assert grads[0].shape == (4, 10) and np.abs(grads[0].asnumpy()).sum() > 0


def test_transformer_lm_learns():
    """The analog of ``test_transformer_lm_learns``: the GPT-style LM,
    attention through ``FlashAttention``'s plain versions on the CPU,
    learns the next token of a cyclic sequence through ``Module.fit``."""
    with mt.cpu():
        sym = mt.models.transformer.get_symbol(
            num_classes=31, seq_len=16, num_hidden=32, num_heads=2,
            num_layers=1)
        rng = np.random.RandomState(0)
        seqs = np.stack([np.arange(i, i + 17) % 31
                         for i in rng.randint(0, 31, 128)])
        X, Y = seqs[:, :16].astype("f"), seqs[:, 1:].astype("f")
        it = mt.io.NDArrayIter(X, Y, batch_size=32, shuffle=True)
        mod = mt.mod.Module(sym)
        metric = mt.metric.Perplexity(None)
        mod.fit(it, num_epoch=12, optimizer="adam",
                optimizer_params={"learning_rate": 3e-3},
                initializer=mt.init.Xavier(factor_type="in", magnitude=2.0),
                eval_metric=metric)
        assert metric.get()[1] < 2.0
        it2 = mt.io.NDArrayIter(X, Y, batch_size=32, shuffle=False)
        correct = total = 0
        for b in it2:
            mod.forward(b, is_train=False)
            out = mod.get_outputs()[0].asnumpy().reshape(32, 16, 31)
            lab = b.label[0].asnumpy()
            correct += (out.argmax(-1) == lab).sum()
            total += lab.size
    assert correct / total > 0.9, correct / total


def _predict_jax(prefix, epoch, x):
    mod = JaxModule.load(prefix, epoch, context=mx.cpu())
    mod.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))], for_training=False)
    return mod.predict(mx.io.NDArrayIter(x, np.zeros(len(x), "f"),
                                         batch_size=20)).asnumpy()


def _predict_port(prefix, epoch, x):
    mod = Module.load(prefix, epoch, context=mt.cpu())
    mod.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))], for_training=False)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, np.zeros(len(x), "f"), batch_size=20)
    return mod.predict(it).asnumpy()


def test_checkpoint_saved_by_the_port_loads_in_the_jax_package(tmp_path):
    train = _port_iter()
    mod = Module(_softmax_mlp(mt), context=mt.cpu())
    mod.fit(train, num_epoch=2, optimizer_params={"learning_rate": 0.5},
            initializer=mt.init.Xavier())
    prefix = str(tmp_path / "port")
    mod.save_checkpoint(prefix, 2)
    x, _ = _toy()
    train.reset()
    want = mod.predict(train).asnumpy()
    np.testing.assert_allclose(_predict_jax(prefix, 2, x), want,
                               **FORWARD_TOL)
    np.testing.assert_allclose(_predict_port(prefix, 2, x), want,
                               **FORWARD_TOL)


def test_checkpoint_saved_by_the_jax_package_loads_in_the_port(tmp_path):
    x, y = _toy()
    mod = JaxModule(_softmax_mlp(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=20), num_epoch=2,
            optimizer_params={"learning_rate": 0.5})
    prefix = str(tmp_path / "jax")
    mod.save_checkpoint(prefix, 2)
    np.testing.assert_allclose(_predict_port(prefix, 2, x),
                               _predict_jax(prefix, 2, x), **FORWARD_TOL)


def test_optimizer_states_round_trip(tmp_path):
    train = _port_iter()
    mod = Module(_softmax_mlp(mt), context=mt.cpu())
    mod.fit(train, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    mod2 = Module.load(prefix, 1, load_optimizer_states=True,
                       context=mt.cpu())
    mod2.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    mod2.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    a, b = mod._updater.states, mod2._updater.states
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k].asnumpy(), b[k].asnumpy())


def test_requests_the_port_cannot_honour_raise(monkeypatch):
    sym = _softmax_mlp(mt)
    with pytest.raises(mt.MXNetError, match="mesh"):
        Module(sym, context=object())               # neither a mesh
    # several contexts take the classic path, fused mode or not
    for mode in ("auto", "always"):
        monkeypatch.setenv("MXTPU_MODULE_FUSED", mode)
        mod = Module(sym, context=[mt.cpu(0), mt.cpu(1)])
        mod.bind(data_shapes=[("data", (4, 10))],
                 label_shapes=[("softmax_label", (4,))])
        assert mod._trainer is None and len(mod._exec_group.execs) == 2
    monkeypatch.delenv("MXTPU_MODULE_FUSED")
    mod = Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    # dist_async has no counterpart, as in the JAX package
    with pytest.raises(mt.MXNetError, match="dist_async"):
        mod.init_optimizer(kvstore="dist_async")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gpu = Module(sym)         # the default context, the card: fused path
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        gpu.bind(data_shapes=[("data", (4, 10))],
                 label_shapes=[("softmax_label", (4,))])
