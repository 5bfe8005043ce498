"""The fused Trainer's rematerialisation policies (``remat=``), on the
CPU: each policy's steps against ``none``'s (a Dropout net too, so the
recompute must draw the forward's masks again) and against the JAX
package's ``Trainer(remat=...)``; the bytes autograd saves for the
backward fall from ``none`` to ``nothing``."""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import Trainer, remat_policy

POLICIES = ["none", "convs_dots", "dots", "nothing"]
# the JAX package's own remat tolerance (tests/test_parallel.py)
JAX_TOL = dict(rtol=2e-5, atol=2e-6)
# a policy against none in the port: the same ops on the same inputs
PORT_TOL = dict(rtol=1e-6, atol=1e-7)


def _conv_bn(sym):
    """``tests/test_parallel.py::test_trainer_remat_matches_no_remat``'s
    net: a convolution, BatchNorm, ReLU and a head."""
    data = sym.Variable("data")
    net = sym.Convolution(data, num_filter=8, kernel=(3, 3), layout="NHWC",
                          name="c1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _dropout_mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Dropout(net, p=0.4)
    net = sym.FullyConnected(net, num_hidden=16, name="fc2")
    net = sym.Activation(net, act_type="tanh")
    net = sym.Dropout(net, p=0.3)
    net = sym.FullyConnected(net, num_hidden=4, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")


def _lm(pkg):
    models = importlib.import_module(pkg.__name__ + ".models")
    return models.transformer.get_symbol(
        seq_len=8, num_classes=11, num_hidden=16, num_heads=2, num_layers=2)


CASES = {
    "conv_bn": (_conv_bn, {"data": (8, 6, 6, 3)}, (8,), 4),
    "dropout_mlp": (_dropout_mlp, {"data": (8, 12)}, (8,), 4),
    "lm": (_lm, {"data": (4, 8)}, (4, 8), 11),
}


def _batch(case, seed=5):
    _, data_shapes, label_shape, classes = CASES[case]
    rng = np.random.RandomState(seed)
    shape = data_shapes["data"]
    x = rng.randint(0, classes, shape).astype("f") if case == "lm" \
        else rng.randn(*shape).astype("f")
    y = rng.randint(0, classes, label_shape).astype("f")
    return {"data": x, "softmax_label": y}


def _params(symbol, shapes, seed=3):
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (np.ones(s) if n.endswith("_gamma")
                else rng.normal(0, 0.3, s)).astype("f")
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def _port_run(case, policy, steps=3):
    make, data_shapes, label_shape, _ = CASES[case]
    symbol = make(mt.sym) if case != "lm" else make(mt)
    shapes = dict(data_shapes, softmax_label=label_shape)
    batch = _batch(case)
    with mt.cpu():
        mt.random.seed(11)
        t = Trainer(symbol, mt.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8),
            remat=policy)
        t.bind(data_shapes=data_shapes,
               label_shapes={"softmax_label": label_shape})
        t.init_params(arg_params=_params(symbol, shapes))
        for _ in range(steps):
            t.step(batch)
    return t, {n: v.numpy() for n, v in t.params.items()}


def _jax_run(case, policy, steps=3):
    make, data_shapes, label_shape, _ = CASES[case]
    symbol = make(mx.sym) if case != "lm" else make(mx)
    shapes = dict(data_shapes, softmax_label=label_shape)
    t = jpar.Trainer(symbol, mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8),
        remat=policy)
    t.bind(data_shapes=data_shapes,
           label_shapes={"softmax_label": label_shape})
    t.init_params(arg_params=_params(symbol, shapes))
    batch = _batch(case)
    for _ in range(steps):
        t.step(batch)
    return {n: np.asarray(v) for n, v in t.params.items()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_each_policy_steps_as_none_does(case, policy):
    """Remat changes where the backward's residuals come from, never the
    math: three steps under each policy end where ``none``'s do.  The
    Dropout net's recompute draws from the generator's twin, set to the
    generator's state before the step, so its masks are the forward's
    (with PyTorch's ``preserve_rng_state`` alone they would differ)."""
    _, base = _port_run(case, "none")
    _, got = _port_run(case, policy)
    for n in base:
        np.testing.assert_allclose(got[n], base[n], err_msg=n, **PORT_TOL)


@pytest.mark.parametrize("case", ["conv_bn", "lm"])
@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_against_the_jax_trainer(case, policy):
    _, got = _port_run(case, policy)
    want = _jax_run(case, policy)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **JAX_TOL)


def test_the_recompute_replays_the_dropout_masks():
    """Without the twin the recompute draws from the generator itself,
    past the forward's draws: new masks, and the run parts from
    ``none``'s."""
    t, _ = _port_run("dropout_mlp", "nothing", steps=0)
    _, base = _port_run("dropout_mlp", "none")
    t._twin = None
    with mt.cpu():
        for _ in range(3):
            t.step(_batch("dropout_mlp"))
    assert any(not np.allclose(t.params[n].numpy(), base[n], **PORT_TOL)
               for n in base)


def _saved_bytes(t, batch):
    """Bytes of the tensors autograd packs for the backward in one step
    (``torch.autograd.graph.saved_tensors_hooks``)."""
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x

    with mt.cpu(), torch.autograd.graph.saved_tensors_hooks(pack,
                                                            lambda x: x):
        t.step(batch)
    return total[0]


@pytest.mark.parametrize("case", ["conv_bn", "lm"])
def test_saved_bytes_fall_from_none_to_nothing(case):
    saved = {p: _saved_bytes(_port_run(case, p, steps=0)[0], _batch(case))
             for p in ("none", "nothing")}
    assert saved["nothing"] < saved["none"] / 4, saved


def test_policy_names():
    assert remat_policy("none") is None and remat_policy("") is None
    for p in POLICIES[1:]:
        assert callable(remat_policy(p))
    with pytest.raises(mt.MXNetError, match="unknown remat policy"):
        remat_policy("bogus")


def test_remat_env_default(monkeypatch):
    monkeypatch.setenv("MXTPU_REMAT", "convs_dots")
    with mt.cpu():
        t = Trainer(_dropout_mlp(mt.sym), mt.optimizer.SGD())
    assert t.remat == "convs_dots" and t._twin is not None
