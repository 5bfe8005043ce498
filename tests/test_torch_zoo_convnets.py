"""The port's image-classification zoo against the JAX package's on the
CPU, first part: AlexNet (with ``LRN``) and VGG; the fit harness of
``examples/image-classification/common/fit.py``; and the helpers the
zoo's other test files (``test_torch_zoo_inception.py``,
``test_torch_zoo_resnext.py``) share.

For each network: argument and aux names and shapes equal the JAX
builder's at the published input; then one forward and backward at
batch 1, 10 classes and a small input, from the same numpy weights,
outputs and every gradient against the JAX executor.  Both graphs run
with Dropout at ``p = 0`` and BatchNorm on its moving statistics
(``use_global_stats``), set in the symbol's JSON: the two packages draw
Dropout masks from different generators (ROADMAP §C), and with batch
statistics over one image the gradients are ill-conditioned (vgg-16 with
``batch_norm`` at 64^2: conv4_2's gradient 5.2e-3 from a float64 run in
the JAX package, 5.5e-6 in the port).  BatchNorm's training forward and
backward are held by ``test_torch_conv_pool_bn.py`` and the ResNet
tests.  The classifier's weights are scaled down so the softmax does not
saturate (where it does, the label's ``p - 1`` is rounding noise).

Tolerance: float32 on both sides, sums in another order; every output
and gradient within 1e-5 of the JAX side's by relative norm (measured:
2.5e-6 at worst, inception-resnet-v2's b8_2_3r_conv_weight; a wrong
graph is off by far more).  The JAX side binds with
``MXTPU_GRAPH_LINT=0``: its lint is slow on these graphs (ROADMAP §C)."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models

import mxnet_tpu_torch as mt

REL_TOL = 1e-5
CLASSES = 10


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def names_and_shapes(sym, shape):
    args, outs, aux = sym.infer_shape(data=shape)
    return (list(zip(sym.list_arguments(), map(tuple, args))),
            list(zip(sym.list_auxiliary_states(), map(tuple, aux))),
            [tuple(o) for o in outs], sym.list_outputs())


def check_names_and_shapes(network, kw, image):
    shape = (2, 3, image, image)
    want = jax_models.get_symbol(network, num_classes=1000, **kw)
    got = mt.models.get_symbol(network, num_classes=1000, **kw)
    assert names_and_shapes(got, shape) == names_and_shapes(want, shape)


def _comparable(pkg, sym):
    """``sym`` with Dropout at p = 0 and BatchNorm on its moving
    statistics, through its JSON."""
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = "0.0"
        elif node["op"] == "BatchNorm":
            node["attrs"]["use_global_stats"] = "True"
    return pkg.sym.load_json(json.dumps(graph))


def _weights(sym, shape, seed=0):
    """He-normal weights (the classifier's at 1e-2 of it), gamma near 1,
    small biases and betas, moving statistics near (0, 1), an N(0, 1)
    image and a label, as numpy."""
    rng = np.random.RandomState(seed)
    args, _, auxs = sym.infer_shape(data=shape, softmax_label=shape[:1])
    arg = {}
    for n, s in zip(sym.list_arguments(), args):
        if n == "data":
            arg[n] = rng.standard_normal(s)
        elif n == "softmax_label":
            arg[n] = rng.randint(0, CLASSES, s)
        elif n.endswith("_gamma"):
            arg[n] = 1 + 0.1 * rng.standard_normal(s)
        elif n.endswith(("_beta", "_bias")):
            arg[n] = 0.1 * rng.standard_normal(s)
        else:
            head = len(s) == 2 and s[0] == CLASSES
            arg[n] = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:])) \
                * (1e-2 if head else 1.0)
    aux = {n: (1 + 0.2 * rng.rand(*s)) if n.endswith("_var")
           else 0.1 * rng.standard_normal(s)
           for n, s in zip(sym.list_auxiliary_states(), auxs)}
    return ({k: v.astype("f") for k, v in arg.items()},
            {k: v.astype("f") for k, v in aux.items()})


def _forward_backward(sym, arg, aux, ctx):
    exe = sym.simple_bind(ctx, data=arg["data"].shape,
                          softmax_label=arg["softmax_label"].shape)
    for k, v in arg.items():
        exe.arg_dict[k][:] = v
    for k, v in aux.items():
        exe.aux_dict[k][:] = v
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return out, {k: v.asnumpy() for k, v in exe.grad_dict.items()
                 if v is not None}


def check_forward_backward(monkeypatch, network, kw, image):
    """One forward and backward of both packages' ``network`` at batch 1
    of ``image``^2: the output and every gradient within REL_TOL."""
    monkeypatch.setenv("MXTPU_GRAPH_LINT", "0")
    jsym = _comparable(mx, jax_models.get_symbol(network,
                                                 num_classes=CLASSES, **kw))
    with mt.cpu():
        tsym = _comparable(mt, mt.models.get_symbol(
            network, num_classes=CLASSES, **kw))
    arg, aux = _weights(jsym, (1, 3, image, image))
    want_out, want = _forward_backward(jsym, arg, aux, mx.cpu())
    got_out, got = _forward_backward(tsym, arg, aux, mt.cpu())
    # a saturated softmax would hide the gradients below it
    assert want_out.max() < 0.5
    assert rel(got_out, want_out) < REL_TOL
    assert sorted(got) == sorted(want)
    errors = {k: rel(got[k], w) for k, w in want.items()
              if k != "softmax_label"}
    worst = max(errors, key=errors.get)
    assert errors[worst] < REL_TOL, (worst, errors[worst])
    assert all(np.isfinite(g).all() for g in got.values())
    assert all(np.abs(g).max() > 0 for k, g in got.items()
               if k.endswith("_weight"))


@pytest.mark.parametrize("network,kw,image", [
    ("alexnet", {}, 224),
    ("vgg-11", {}, 224),
    ("vgg-13", {}, 224),
    ("vgg-16", dict(batch_norm=True), 224),
    ("vgg-19", {}, 224),
])
def test_symbols_match_the_jax_zoo(network, kw, image):
    check_names_and_shapes(network, kw, image)


@pytest.mark.parametrize("network,kw,image", [
    ("alexnet", {}, 67),                  # the last pooling sees 3 x 3
    ("vgg-11", {}, 32),
    ("vgg-11", dict(batch_norm=True), 32),
    ("vgg-16", {}, 32),
    ("vgg-16", dict(batch_norm=True), 32),
])
def test_forward_backward_match_the_jax_executor(monkeypatch, network, kw,
                                                 image):
    check_forward_backward(monkeypatch, network, kw, image)


@pytest.mark.parametrize("nsize", [5, 4, 1])
def test_lrn_matches_the_jax_op(nsize):
    """``LRN`` forward and backward (autograd) against the JAX op for odd
    and even windows: within 1e-6 of the JAX side's by relative norm
    (measured ~5e-8)."""
    rng = np.random.RandomState(nsize)
    x = rng.randn(2, 7, 5, 6).astype("f")
    head = rng.randn(*x.shape).astype("f")
    kw = dict(nsize=nsize, alpha=1e-2, beta=0.75, knorm=2.0)
    results = []
    for m, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = m.sym.LRN(m.sym.Variable("x"), **kw)
        exe = sym.simple_bind(ctx, x=x.shape)
        exe.arg_dict["x"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(m.nd.array(head, ctx=ctx))
        results.append((out, exe.grad_dict["x"].asnumpy()))
    (want, want_g), (got, got_g) = results
    assert rel(got, want) < 1e-6 and rel(got_g, want_g) < 1e-6
    assert rel(got, x) > 1e-3


def _fit(pkg, ctx, sym, x, y, metrics):
    """fit.py's settings at a tiny size: SGD momentum 0.9, wd 1e-4, a
    MultiFactorScheduler stepping inside the run, Xavier("gaussian",
    "in", 2), a device store, accuracy and top-5 accuracy."""
    pkg.random.seed(3)
    with ctx:
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        mod = pkg.mod.Module(sym, context=ctx)
        mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd",
                optimizer_params={
                    "learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4,
                    "rescale_grad": 1.0 / 8,
                    "lr_scheduler": pkg.lr_scheduler.MultiFactorScheduler(
                        step=[2], factor=0.1)},
                initializer=pkg.init.Xavier(rnd_type="gaussian",
                                            factor_type="in", magnitude=2),
                eval_metric=metrics)
    assert mod._trainer is not None
    return mod


def test_fit_harness_matches_the_jax_package(monkeypatch):
    """``Module.fit`` of AlexNet at 67^2 (Dropout at p = 0) on both
    packages' fused paths with fit.py's settings, four steps with the lr
    stepping down after two: the same initial draws, the same trained
    parameters (within 1e-5 by relative norm) and the same accuracy and
    top-5 accuracy.  The lr (1e-3) keeps the softmax off saturation: at
    1e-2 the outputs are one-hot after a step, and top-5 of the nine
    exact zeros is a tie that each package breaks its own way."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "always")
    monkeypatch.setenv("MXTPU_GRAPH_LINT", "0")
    rng = np.random.RandomState(0)
    x = rng.standard_normal((32, 3, 67, 67)).astype("f")
    y = rng.randint(0, CLASSES, 32).astype("f")
    sym = jax_models.get_symbol("alexnet", num_classes=CLASSES)
    jmetric = mx.metric.create(["accuracy", mx.metric.create(
        "top_k_accuracy", top_k=5)])
    jmod = _fit(mx, mx.cpu(), _comparable(mx, sym), x, y, jmetric)
    with mt.cpu():
        tsym = _comparable(mt, mt.models.get_symbol("alexnet",
                                                    num_classes=CLASSES))
    tmetric = mt.metric.create(["accuracy", mt.metric.create(
        "top_k_accuracy", top_k=5)])
    tmod = _fit(mt, mt.cpu(), tsym, x, y, tmetric)
    assert tmod._trainer.num_update == 4
    assert tmod._trainer._lr_cache == pytest.approx(1e-4)
    want, _ = jmod.get_params()
    got, _ = tmod.get_params()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert rel(got[k].asnumpy(), w.asnumpy()) < REL_TOL, k
    assert tmetric.get() == jmetric.get()
    assert tmetric.get()[0] == ["accuracy", "top_k_accuracy_5"]
    assert isinstance(tmod._trainer.params["fc3_weight"], torch.Tensor)
