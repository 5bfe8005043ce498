"""The port's Executor: the analogs of ``tests/test_executor.py`` on the
CPU, and every parameter gradient of the tiny transformer LM against the
JAX package's Executor, with the same weights carried across by
``convert.params_from_mxnet_tpu``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jax_models

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert

TINY = dict(num_classes=31, seq_len=16, num_hidden=32, num_heads=2,
            num_layers=1)
BATCH = 4
# float32 on both sides through one block, the JAX side's attention in
# Pallas interpret mode and the port's in its plain version: products and
# sums in another order; each gradient agrees to ~4e-7 of its norm, while
# a wrong formula is off by 1e-2 or more
GRAD_REL_TOL = 1e-5


def _arr(x):
    return mt.nd.array(np.asarray(x, dtype=np.float32), ctx=mt.cpu())


def test_bind_forward_backward():
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    c = a * b + a
    rng = np.random.RandomState(0)
    av, bv = (rng.randn(3, 4).astype("f") for _ in range(2))
    exe = c.bind(mt.cpu(), {"a": _arr(av), "b": _arr(bv)},
                 args_grad={"a": _arr(np.zeros((3, 4))),
                            "b": _arr(np.zeros((3, 4)))})
    out = exe.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, av * bv + av, atol=1e-6)
    og = rng.randn(3, 4).astype("f")
    exe.backward(_arr(og))
    np.testing.assert_allclose(exe.grad_dict["a"].asnumpy(), og * (bv + 1),
                               atol=1e-5)
    np.testing.assert_allclose(exe.grad_dict["b"].asnumpy(), og * av,
                               atol=1e-5)
    with pytest.raises(mt.MXNetError, match="forward"):
        exe.backward(_arr(og))      # the graph went with the first backward


def test_grad_req_add():
    a = mt.sym.Variable("a")
    out = mt.sym.square(a)
    av = np.random.RandomState(1).randn(2, 2).astype("f")
    ga = _arr(np.ones((2, 2)))
    exe = out.bind(mt.cpu(), {"a": _arr(av)}, args_grad={"a": ga},
                   grad_req="add")
    exe.forward(is_train=True)
    exe.backward(_arr(np.ones((2, 2))))
    np.testing.assert_allclose(ga.asnumpy(), 1 + 2 * av, atol=1e-5)


def test_grad_req_null():
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    out = a * b
    exe = out.bind(mt.cpu(), {"a": _arr(np.ones(2)), "b": _arr(np.ones(2))},
                   args_grad={"a": _arr(np.zeros(2))},
                   grad_req={"a": "write", "b": "null"})
    exe.forward(is_train=True)
    exe.backward(_arr(np.ones(2)))
    np.testing.assert_allclose(exe.grad_dict["a"].asnumpy(), [1, 1])
    assert "b" not in exe.grad_dict


def test_simple_bind_and_missing_head_gradient():
    x = mt.sym.Variable("x")
    fc = mt.sym.FullyConnected(x, num_hidden=4, name="fc")
    exe = fc.simple_bind(ctx=mt.cpu(), x=(2, 3))
    assert exe.arg_dict["fc_weight"].shape == (4, 3)
    # arguments start at zero, as the reference's do
    assert not exe.arg_dict["fc_weight"].asnumpy().any()
    exe.arg_dict["fc_weight"][:] = 1.0
    exe.forward(is_train=True, x=np.ones((2, 3), "f"))
    assert exe.outputs[0].shape == (2, 4)
    exe.backward()          # a missing head gradient is ones
    np.testing.assert_allclose(exe.grad_dict["fc_bias"].asnumpy(), [2] * 4)
    np.testing.assert_allclose(exe.grad_dict["x"].asnumpy(), 4 * np.ones((2, 3)))


def test_forward_kwargs_and_output_dict():
    x = mt.sym.Variable("x")
    out = mt.sym.square(x, name="s")
    exe = out.simple_bind(ctx=mt.cpu(), x=(2, 2))
    o1 = exe.forward(x=np.full((2, 2), 2.0, dtype="f"))[0].asnumpy()
    np.testing.assert_allclose(o1, 4)
    o2 = exe.forward(x=mt.nd.full((2, 2), 3.0, ctx=mt.cpu()))[0].asnumpy()
    np.testing.assert_allclose(o2, 9)
    assert list(exe.output_dict) == ["s_output"]
    with pytest.raises(mt.MXNetError, match="unknown argument"):
        exe.forward(y=np.ones((2, 2), "f"))


def test_bind_raises_on_the_card_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = mt.sym.Variable("x")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.sym.square(x).simple_bind(ctx=mt.gpu(), x=(2, 2))


def test_transformer_gradients_match_jax_executor():
    with mx.name.NameManager():
        jsym = jax_models.get_symbol("transformer", **TINY)
    with mt.name.NameManager():
        tsym = mt.models.transformer.get_symbol(**TINY)
    names = jsym.list_arguments()
    assert tsym.list_arguments() == names
    rng = np.random.RandomState(0)
    shapes, _, _ = jsym.infer_shape(data=(BATCH, 16),
                                    softmax_label=(BATCH, 16))
    params = {n: rng.normal(0, 0.3, s).astype("f")
              for n, s in zip(names, shapes)
              if n not in ("data", "softmax_label")}
    data = rng.randint(0, 31, (BATCH, 16)).astype("f")
    label = rng.randint(0, 31, (BATCH, 16)).astype("f")
    req = {n: "write" if n in params else "null" for n in names}

    jex = jsym.simple_bind(mx.cpu(), grad_req=req, data=(BATCH, 16),
                           softmax_label=(BATCH, 16))
    for n, v in params.items():
        jex.arg_dict[n][:] = v
    jex.forward(is_train=True, data=data, softmax_label=label)
    jex.backward()

    weights, _ = convert.params_from_mxnet_tpu(
        {n: jex.arg_dict[n].asnumpy() for n in params}, {})
    tex = tsym.simple_bind(mt.cpu(), grad_req=req, data=(BATCH, 16),
                           softmax_label=(BATCH, 16))
    tex.copy_params_from({n: mt.nd.NDArray(v) for n, v in weights.items()})
    tex.forward(is_train=True, data=data, softmax_label=label)
    tex.backward()

    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
    assert set(tex.grad_dict) == set(params)
    for n in params:
        got, want = tex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < GRAD_REL_TOL, (n, rel)


@pytest.mark.parametrize("kwargs,dshape,lshape", [
    (dict(), (6, 5), (6,)),
    (dict(grad_scale=0.5, normalization="batch"), (6, 5), (6,)),
    (dict(use_ignore=True, ignore_label=1, normalization="valid"),
     (6, 5), (6,)),
    (dict(multi_output=True, use_ignore=True, ignore_label=0,
          normalization="valid"), (3, 4, 5), (3, 5)),
    (dict(out_grad=True), (6, 5), (6,)),
    (dict(), (6, 5), (6, 5)),                         # dense labels
])
def test_softmax_output_gradient_matches_jax_executor(kwargs, dshape,
                                                       lshape):
    rng = np.random.RandomState(5)
    data = rng.randn(*dshape).astype("f")
    if lshape == dshape:
        label = rng.rand(*lshape).astype("f")
    else:
        label = rng.randint(0, dshape[1], lshape).astype("f")
    head = rng.randn(*dshape).astype("f")
    grads = []
    for m, ctx, arr in ((mx, mx.cpu(), mx.nd.array), (mt, mt.cpu(), _arr)):
        sym = m.sym.SoftmaxOutput(m.sym.Variable("data"),
                                  m.sym.Variable("label"), name="sm",
                                  **kwargs)
        exe = sym.bind(ctx, {"data": arr(data), "label": arr(label)},
                       args_grad={"data": arr(np.zeros(dshape, "f"))},
                       grad_req={"data": "write", "label": "null"})
        exe.forward(is_train=True)
        exe.backward([arr(head)])
        grads.append((exe.outputs[0].asnumpy(),
                      exe.grad_dict["data"].asnumpy()))
    (jout, jgrad), (tout, tgrad) = grads
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-6, atol=1e-7)
