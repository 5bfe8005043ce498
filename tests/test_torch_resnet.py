"""The port's model zoo (ResNet, LeNet, MLP), its fused Trainer with
BatchNorm state, ``Module.fit`` and ``callback.py`` on the CPU, against
the JAX package where both can run: the same symbols by name and shape,
the same initial weights moved across by ``params_from_mxnet_tpu``, the
same numpy batches from a seed.

Tolerances: float32 on both sides, products and sums in another order;
three SGD-momentum steps of the tiny ResNet leave parameters, moving
statistics and outputs within a relative norm of 1e-5 of the JAX
Trainer's (measured: ~3e-6 at worst; a wrong gradient or moving update
is off by 1e-2 or more).  The eval forward on a JAX checkpoint: 1e-5."""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models
from mxnet_tpu.parallel import Trainer as JaxTrainer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.parallel import Trainer

REL_TOL = 1e-5
TINY = dict(num_classes=4, num_layers=8, image_shape=(8, 8, 3),
            layout="NHWC")
BATCH = 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _names_and_shapes(sym, shape):
    args, outs, aux = sym.infer_shape(data=shape)
    return (list(zip(sym.list_arguments(), map(tuple, args))),
            list(zip(sym.list_auxiliary_states(), map(tuple, aux))),
            [tuple(o) for o in outs], sym.list_outputs())


@pytest.mark.parametrize("network,kw,shape", [
    ("resnet-50", dict(layout="NHWC"), (2, 224, 224, 3)),
    ("resnet-50", dict(), (2, 3, 224, 224)),
    ("resnet-50", dict(version=1, layout="NHWC"), (2, 224, 224, 3)),
    ("resnet-18", dict(version=1), (2, 3, 224, 224)),
    ("resnet-50", dict(layout="NHWC", conv0_space_to_depth=True),
     (2, 224, 224, 3)),
    ("resnet-20", dict(image_shape=(3, 32, 32)), (2, 3, 32, 32)),
    ("resnet-20", dict(image_shape=(3, 32, 32), layout="NHWC", version=1),
     (2, 32, 32, 3)),
    ("lenet", dict(), (2, 1, 28, 28)),
    ("mlp", dict(), (2, 1, 28, 28)),
])
def test_symbols_match_the_jax_zoo(network, kw, shape):
    want = jax_models.get_symbol(network, num_classes=1000, **kw)
    got = mt.models.get_symbol(network, num_classes=1000, **kw)
    assert _names_and_shapes(got, shape) == _names_and_shapes(want, shape)


def test_resnet50_nhwc_weights_are_hwio():
    sym = mt.models.get_symbol("resnet-50", num_classes=1000, layout="NHWC")
    args, _, _ = sym.infer_shape(data=(1, 224, 224, 3))
    shapes = dict(zip(sym.list_arguments(), args))
    assert shapes["conv0_weight"] == (7, 7, 3, 64)
    assert shapes["stage1_unit1_conv2_weight"] == (3, 3, 64, 64)
    assert sum(np.prod(s) for n, s in shapes.items()
               if n not in ("data", "softmax_label")) == 25_549_480


@pytest.mark.parametrize("network", ["alexnet", "vgg-16", "inception-bn",
                                     "resnext-50"])
def test_unported_zoo_networks_raise(network):
    """The zoo's other networks are ported now: each builds by its
    ``--network`` name, and a name the zoo lacks raises."""
    assert mt.models.get_symbol(network).list_outputs() == ["softmax_output"]
    with pytest.raises(ValueError, match="unknown network"):
        mt.models.get_symbol("not-" + network)


def _tiny_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.normal(0, 1, (BATCH, 8, 8, 3)).astype("f"),
             "softmax_label": np.arange(BATCH).astype("f")}
            for _ in range(n)]


def _shapes():
    return {"data": (BATCH, 8, 8, 3)}, {"softmax_label": (BATCH,)}


def _sgd(m):
    return m.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                           rescale_grad=1.0 / BATCH)


def test_trainer_steps_match_the_jax_trainer():
    """Three fused SGD-momentum steps of the tiny NHWC ResNet from the
    same weights: outputs, parameters and every BatchNorm moving
    statistic."""
    batches = _tiny_batches(3)
    jt = JaxTrainer(jax_models.resnet.get_symbol(**TINY), _sgd(mx))
    jt.bind(*_shapes())
    jt.init_params(mx.init.Xavier())
    arg, aux = jt.get_params()
    init = ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})
    jax_outs = [jt.step(b)[0].asnumpy() for b in batches]
    arg, aux = jt.get_params()

    with mt.cpu():
        t = Trainer(mt.models.resnet.get_symbol(**TINY), _sgd(mt))
    t.bind(*_shapes())
    arg0, aux0 = params_from_mxnet_tpu(*init)
    t.init_params(arg_params=arg0, aux_params=aux0)
    outs = [t.step(b)[0].asnumpy() for b in batches]
    for got, want in zip(outs, jax_outs):
        assert _rel(got, want) < REL_TOL
    assert sorted(t.params) == sorted(arg)
    assert sorted(t.aux) == sorted(aux)
    for name, want in arg.items():
        assert _rel(t.params[name].numpy(), want.asnumpy()) < REL_TOL, name
    moved = 0
    for name, want in aux.items():
        got = t.aux[name]
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want.asnumpy()) < REL_TOL, name
        moved += not np.array_equal(got.numpy(), init[1][name])
    assert moved == len(aux)


def test_bfloat16_trainer_learns_with_float32_moving_stats():
    """The analog of ``tests/test_models.py::test_trainer_step_resnet_tiny``:
    bfloat16 compute, the loss on a memorizable batch falls, and the
    moving statistics stay float32 masters that the steps move."""
    with mt.cpu():
        t = Trainer(mt.models.resnet.get_symbol(**TINY),
                    mt.optimizer.SGD(learning_rate=0.1),
                    compute_dtype="bfloat16")
    t.bind(*_shapes())
    mt.random.seed(0)
    t.init_params(mt.init.Xavier())
    before = {n: v.clone() for n, v in t.aux.items()}
    batch = {"data": _tiny_batches(1)[0]["data"],
             "softmax_label": np.arange(BATCH, dtype=np.int32)}

    def nll(out):
        return -np.log(out[np.arange(BATCH), np.arange(BATCH)] + 1e-8).mean()

    out0 = t.step(batch)[0].asnumpy()
    assert out0.shape == (BATCH, 4) and np.isfinite(out0).all()
    for _ in range(10):
        out = t.step(batch)[0].asnumpy()
    assert nll(out) < nll(out0)
    for n, v in t.aux.items():
        assert v.dtype == torch.float32
        assert not torch.equal(v, before[n]), n


def _fused_module(sym, monkeypatch, **kw):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "always")
    with mt.cpu():
        return mt.mod.Module(sym, context=mt.cpu(), **kw)


def test_fused_module_carries_bn_state_and_scores_on_moving_stats(
        monkeypatch, tmp_path):
    """``Module.fit`` on the fused path with BatchNorm: ``get_params``
    holds the trained moving statistics, a checkpoint carries them, and
    ``score``/``predict`` normalise with them (``is_train=False``): the
    eval output equals the JAX executor's on the same params and aux."""
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (16, 8, 8, 3)).astype("f")
    y = rng.randint(0, 4, 16).astype("f")
    sym = mt.models.resnet.get_symbol(**TINY)
    mod = _fused_module(sym, monkeypatch)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    mt.random.seed(0)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mt.init.Xavier(),
            epoch_end_callback=mt.callback.do_checkpoint(
                str(tmp_path / "r")))
    assert mod._trainer is not None
    arg, aux = mod.get_params()
    assert all(not np.array_equal(aux[n].asnumpy(), np.zeros_like(
        aux[n].asnumpy())) for n in aux if n.endswith("moving_mean"))
    _, arg2, aux2 = mt.model.load_checkpoint(str(tmp_path / "r"), 2)
    for n in aux:
        np.testing.assert_array_equal(aux2[n].asnumpy(), aux[n].asnumpy())
    it.reset()
    preds = mod.predict(it).asnumpy()

    jsym = jax_models.resnet.get_symbol(**TINY)
    exe = jsym.simple_bind(mx.cpu(), grad_req="null", data=(16, 8, 8, 3),
                           softmax_label=(16,))
    exe.copy_params_from({n: mx.nd.array(v.asnumpy())
                          for n, v in arg.items()},
                         {n: mx.nd.array(v.asnumpy())
                          for n, v in aux.items()})
    want = exe.forward(is_train=False, data=mx.nd.array(x))[0].asnumpy()
    assert _rel(preds, want) < REL_TOL
    it.reset()
    acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc == np.mean(preds.argmax(1) == y)


def test_a_jax_checkpoint_loads_into_the_port(tmp_path):
    """A checkpoint the JAX package saves for the tiny ResNet loads into
    the port's Module unchanged, and the eval forward agrees."""
    jsym = jax_models.resnet.get_symbol(**TINY)
    exe = jsym.simple_bind(mx.cpu(), grad_req="null", data=(BATCH, 8, 8, 3),
                           softmax_label=(BATCH,))
    rng = np.random.RandomState(2)
    arg = {n: mx.nd.array(rng.normal(0, 0.3, a.shape).astype("f"))
           for n, a in exe.arg_dict.items()
           if n not in ("data", "softmax_label")}
    aux = {n: mx.nd.array((rng.random_sample(a.shape) + 0.5).astype("f"))
           for n, a in exe.aux_dict.items()}
    prefix = str(tmp_path / "jax")
    mx.model.save_checkpoint(prefix, 1, jsym, arg, aux)
    x = rng.normal(0, 1, (BATCH, 8, 8, 3)).astype("f")
    exe.copy_params_from(arg, aux)
    want = exe.forward(is_train=False, data=mx.nd.array(x))[0].asnumpy()

    with mt.cpu():
        mod = mt.mod.Module.load(prefix, 1, context=mt.cpu())
        mod.bind([("data", (BATCH, 8, 8, 3))], for_training=False)
        mod.forward(mt.io.DataBatch([mt.nd.array(x)], None),
                    is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    assert _rel(got, want) < REL_TOL


def _synthetic_mnist(n=2000, seed=0):
    """The data of ``tests/test_train.py``: a separable 10-class problem
    standing in for MNIST."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype("f") * 2.0
    y = rng.randint(0, 10, n)
    x = centers[y] + rng.randn(n, 784).astype("f") * 0.8
    return x.astype("f"), y.astype("f")


def test_mlp_module_fit_accuracy():
    """``tests/test_train.py::test_mlp_accuracy`` through the port's
    ``Module.fit`` on the zoo's MLP.  At this learning rate and momentum
    some initial weights diverge, in both packages (the JAX package's
    Module on the zoo MLP: 2 of seeds 0-7), so the shuffle and the
    initial weights are seeded here."""
    x, y = _synthetic_mnist()
    mt.random.seed(0)
    with mt.cpu():
        train = mt.io.NDArrayIter(x[:1600], y[:1600], batch_size=100,
                                  shuffle=True)
        val = mt.io.NDArrayIter(x[1600:], y[1600:], batch_size=100)
        mod = mt.mod.Module(mt.models.get_symbol("mlp", num_classes=10),
                            context=mt.cpu())
        mod.fit(train, eval_data=val, num_epoch=5,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1.0 / 100},
                initializer=mt.init.Xavier())
        val.reset()
        acc = mod.score(val, "acc")[0][1]
    assert acc > 0.95, acc


def test_lenet_conv_module_fit_accuracy():
    """``tests/test_train.py::test_lenet_conv_trains`` through the port:
    Convolution, tanh, max Pooling and FullyConnected on the classic
    path."""
    rng = np.random.RandomState(0)
    n = 400
    centers = rng.randn(4, 1, 12, 12).astype("f") * 1.5
    y = rng.randint(0, 4, n)
    x = centers[y] + rng.randn(n, 1, 12, 12).astype("f") * 0.5
    mt.random.seed(0)
    with mt.cpu():
        train = mt.io.NDArrayIter(x, y.astype("f"), batch_size=50,
                                  shuffle=True)
        data = mt.sym.Variable("data")
        conv1 = mt.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                                   name="conv1")
        tanh1 = mt.sym.Activation(conv1, act_type="tanh")
        pool1 = mt.sym.Pooling(tanh1, pool_type="max", kernel=(2, 2),
                               stride=(2, 2))
        flat = mt.sym.Flatten(pool1)
        fc = mt.sym.FullyConnected(flat, num_hidden=4, name="fc")
        net = mt.sym.SoftmaxOutput(fc, name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(train, num_epoch=4,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1.0 / 50},
                initializer=mt.init.Xavier())
        train.reset()
        acc = mod.score(train, "acc")[0][1]
    assert acc > 0.9, acc


def test_zoo_lenet_trains_one_step_on_the_fused_path(monkeypatch):
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (8, 1, 28, 28)).astype("f")
    y = rng.randint(0, 10, 8).astype("f")
    mod = _fused_module(mt.models.get_symbol("lenet"), monkeypatch)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, batch_size=8)
    mt.random.seed(0)
    mod.fit(it, num_epoch=1, initializer=mt.init.Xavier())
    assert mod._trainer is not None and mod._trainer.num_update == 1


def test_checkpoint_callback(tmp_path):
    """``tests/test_train.py::test_checkpoint_callback`` with the port's
    ``callback.do_checkpoint``; ``module_checkpoint`` saves the optimizer
    state too."""
    x, y = _synthetic_mnist(n=200)
    prefix = str(tmp_path / "chk")
    with mt.cpu():
        train = mt.io.NDArrayIter(x, y, batch_size=50)
        data = mt.sym.Variable("data")
        fc = mt.sym.FullyConnected(data, num_hidden=10, name="fc")
        net = mt.sym.SoftmaxOutput(fc, name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(train, num_epoch=2,
                epoch_end_callback=[
                    mt.callback.do_checkpoint(prefix),
                    mt.callback.module_checkpoint(mod, prefix + "-mod",
                                                  period=2,
                                                  save_optimizer_states=True)],
                optimizer_params={"learning_rate": 0.1})
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0002.params")
    assert os.path.exists(prefix + "-mod-0002.states")
    assert not os.path.exists(prefix + "-mod-0001.params")
    _, arg, _ = mt.model.load_checkpoint(prefix, 2)
    assert "fc_weight" in arg


def test_speedometer_and_metric_loggers(caplog):
    """Speedometer reports samples/s every ``frequent`` batches and
    re-arms on a new epoch; the metric loggers and the progress bar."""
    from mxnet_tpu_torch.module.base_module import BatchEndParam
    metric = mt.metric.Accuracy()
    metric.update([mt.nd.array(np.array([0, 1], "f"), ctx=mt.cpu())],
                  [mt.nd.array(np.array([[0.9, 0.1], [0.2, 0.8]], "f"),
                               ctx=mt.cpu())])
    speed = mt.callback.Speedometer(batch_size=2, frequent=2)
    log = mt.callback.log_train_metric(period=1)
    val = mt.callback.LogValidationMetricsCallback()
    bar = mt.callback.ProgressBar(total=4, length=8)
    with caplog.at_level(logging.INFO):
        for nbatch in range(5):
            p = BatchEndParam(epoch=0, nbatch=nbatch, eval_metric=metric,
                              locals=None)
            log(p)
            bar(p)
            speed(p)
        val(BatchEndParam(epoch=0, nbatch=0, eval_metric=metric,
                          locals=None))
    text = caplog.text
    assert "samples/sec" in text
    assert "Train-accuracy=1.000000" in text
    assert "Validation-accuracy" in text
