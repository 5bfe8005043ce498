"""The rest of the Module family on the port: ``SequentialModule``,
``PythonLossModule`` and the legacy ``model.FeedForward``, on the CPU
against the JAX package's (``tests/test_module.py``, ``tests/test_aux.py``,
``tests/test_train.py``, ``examples/module/python_loss.py``).  The
inputs and the initial weights come from a numpy seed."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

# float32 on both sides, sums in another order
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def classic(monkeypatch):
    # the JAX package fuses a lone Module on its CPU mesh under "always";
    # a chain's stages run classic in both packages anyway
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "never")


def _toy(n=200, d=10, classes=2, seed=0):
    """Noisy class prototypes, as ``examples/module/python_loss.py``
    makes them."""
    rng = np.random.RandomState(seed)
    protos = rng.normal(0, 1, (classes, d))
    y = rng.randint(0, classes, n)
    x = (protos[y] + rng.normal(0, 0.6, (n, d))).astype("f")
    return x, y.astype("f")


def _weights(shapes, seed):
    rng = np.random.RandomState(seed)
    return {n: (rng.normal(0, 0.3, s) if n.endswith("weight")
                else np.zeros(s)).astype("f") for n, s in shapes.items()}


def _close(got, want):
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= \
            REL_TOL * max(np.linalg.norm(w), 1e-6), k


def _host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _train_chain(pkg, ctx, build, x, y, init, epochs, opt):
    """Bind, init from ``init``, and train a chain by hand (the loop of
    ``tests/test_module.py``); returns the chain and its accuracy."""
    seq = build(pkg, ctx)
    it = pkg.io.NDArrayIter(x, y, batch_size=20)
    seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    seq.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in init.items()})
    seq.init_optimizer(optimizer_params=opt)
    metric = pkg.metric.create("acc")
    for _ in range(epochs):
        it.reset()
        metric.reset()
        for batch in it:
            seq.forward_backward(batch)
            seq.update()
            seq.update_metric(metric, batch.label)
    return seq, metric.get()[1]


def _softmax_chain(pkg, ctx):
    net1 = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                  name="fc1")
    net1 = pkg.sym.Activation(net1, act_type="relu", name="a1")
    net2 = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=2,
                                  name="fc2")
    net2 = pkg.sym.SoftmaxOutput(net2, name="softmax")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net1, label_names=None, context=ctx))
    seq.add(pkg.mod.Module(net2, context=ctx), take_labels=True,
            auto_wiring=True)
    return seq


def mc_hinge_grad(scores, labels):
    """``examples/module/python_loss.py``'s Crammer-Singer hinge
    gradient, numpy in and out."""
    s = scores.asnumpy()
    y = labels.asnumpy().astype(int)
    n = s.shape[0]
    margin = 1.0 + s - s[np.arange(n), y][:, None]
    margin[np.arange(n), y] = 0.0
    pred = margin.argmax(1)
    grad = np.zeros_like(s)
    viol = margin[np.arange(n), pred] > 0
    grad[viol, y[viol]] -= 1.0
    grad[viol, pred[viol]] += 1.0
    return grad / n


def _hinge_chain(pkg, ctx):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = pkg.sym.Activation(net, name="relu1", act_type="relu")
    scores = pkg.sym.FullyConnected(net, name="fc2", num_hidden=4)
    mlp = pkg.mod.Module(scores, label_names=(), context=ctx)
    loss = pkg.mod.PythonLossModule(grad_func=mc_hinge_grad)
    return pkg.mod.SequentialModule().add(mlp).add(
        loss, take_labels=True, auto_wiring=True)


@pytest.mark.parametrize("build,shapes,classes,opt", [
    (_softmax_chain, {"fc1_weight": (8, 10), "fc1_bias": (8,),
                      "fc2_weight": (2, 8), "fc2_bias": (2,)}, 2,
     {"learning_rate": 0.5}),
    (_hinge_chain, {"fc1_weight": (16, 10), "fc1_bias": (16,),
                    "fc2_weight": (4, 16), "fc2_bias": (4,)}, 4,
     {"learning_rate": 0.2, "momentum": 0.9})],
    ids=["softmax", "python_loss"])
def test_sequential_chain_matches_the_jax_package(build, shapes, classes,
                                                  opt):
    """A chain trained by hand for five epochs from the same weights ends
    at the JAX package's parameters and learns; the python-loss chain
    takes its input gradient from a numpy ``grad_func``."""
    x, y = _toy(classes=classes)
    init = _weights(shapes, seed=1)
    jseq, jacc = _train_chain(mx, mx.cpu(), build, x, y, init, 5, opt)
    with mt.cpu():
        pseq, pacc = _train_chain(mt, mt.cpu(), build, x, y, init, 5, opt)
    _close(_host(pseq.get_params()[0]), _host(jseq.get_params()[0]))
    assert pacc == pytest.approx(jacc) and pacc > 0.8
    grad = pseq._stages[-1].module.get_input_grads()[0]
    assert grad.context == mt.cpu() and grad.dtype == mt.nd.zeros(
        (1,), ctx=mt.cpu()).dtype
    assert pseq.output_shapes == [(n, tuple(s)) for n, s in
                                  jseq.output_shapes]


def test_sequential_chain_fits_and_names_its_faults():
    """``fit`` drives a chain (bind, init, the optimizer of every stage);
    a parameter in two stages and unknown meta keys raise."""
    x, y = _toy(classes=4)
    with mt.cpu():
        seq = _hinge_chain(mt, mt.cpu())
        it = mt.io.NDArrayIter(x, y, batch_size=20)
        seq.fit(it, num_epoch=4, optimizer="sgd",
                optimizer_params={"learning_rate": 0.2, "momentum": 0.9},
                initializer=mt.init.Xavier())
        it.reset()
        assert seq.score(it, "acc")[0][1] > 0.8
        with pytest.raises(ValueError, match="unknown meta"):
            seq.add(mt.mod.PythonLossModule(), typo=True)
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                    name="fc")
        twice = mt.mod.SequentialModule()
        twice.add(mt.mod.Module(net, label_names=None))
        twice.add(mt.mod.Module(net, label_names=None), auto_wiring=True)
        twice.bind([("data", (5, 4))], for_training=False)
        with pytest.raises(ValueError, match="both stage 0"):
            twice.init_params()
    with pytest.raises(NotImplementedError, match="grad_func"):
        loss = mt.mod.PythonLossModule()
        loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
        loss.forward(mt.io.DataBatch([None], [None]), is_train=True)
        loss.backward()


def _ff_net(pkg, hidden):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_feedforward_matches_the_jax_package(tmp_path):
    """``FeedForward`` (``tests/test_train.py::test_feedforward_api``) from
    the same weights in both packages: the same predictions after
    ``fit``; ``save``/``load`` round trips, and a JAX-saved model loads
    and predicts in the port."""
    x, y = _toy(n=240, d=12, classes=4, seed=2)
    init = _weights({"fc_weight": (4, 12), "fc_bias": (4,)}, seed=4)
    preds = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        model = pkg.model.FeedForward(
            _ff_net(pkg, 4), ctx=ctx, num_epoch=3, learning_rate=0.1,
            numpy_batch_size=40,
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in init.items()})
        model.fit(x, y)
        preds.append(model.predict(x))
        model.save(str(tmp_path / pkg.__name__))
    jp, pp = preds
    assert pp.shape == (240, 4)
    np.testing.assert_allclose(pp, jp, rtol=REL_TOL, atol=1e-6)
    assert (pp.argmax(1) == y).mean() > 0.8
    for name in ("mxnet_tpu", "mxnet_tpu_torch"):
        back = mt.model.FeedForward.load(str(tmp_path / name), 3,
                                         ctx=mt.cpu())
        np.testing.assert_allclose(back.predict(x), pp, rtol=REL_TOL,
                                   atol=1e-6)


def test_feedforward_create_trains_and_scores():
    """``FeedForward.create`` (``tests/test_aux.py``'s legacy API case):
    trains, predicts and scores an iterator."""
    x, y = _toy(n=64, d=6, classes=4, seed=0)
    with mt.cpu():
        model = mt.model.FeedForward.create(
            _ff_net(mt, 4), x, y, ctx=mt.cpu(), num_epoch=8,
            optimizer="sgd", learning_rate=0.3,
            initializer=mt.init.Xavier(), numpy_batch_size=16)
        it = mt.io.NDArrayIter(x, y, batch_size=16)
    preds = model.predict(x)
    assert preds.shape == (64, 4)
    assert (preds.argmax(1) == y).mean() > 0.8
    assert model.score(it) > 0.8
