"""The port's ``operator.py`` (CustomOp, CustomOpProp, the ``Custom`` op
and the legacy NumpyOp/NDArrayOp) against the JAX package's on the CPU:
the same Python op registered in both packages, the same numpy inputs
from a seed, outputs and gradients within 1e-5 of the JAX side's
largest magnitude (``torch_parity.rel_err``; the op bodies are numpy on
the host in both, only the surrounding products round).  A Module fit
through a Custom node starts both packages from the same parameters and
holds them within 1e-4 after training (float32 SGD steps summed in
another order).  What the JAX package's ``pure_callback`` does not have
(aux states, ``req``, the declared backward dependencies, the record of
why a step was not captured) is held to the reference's contract."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

from torch_parity import assert_close, check_against_reference, rel_err


def _register_scaled_sigmoid(pkg):
    @pkg.operator.register("port_test_scaled_sigmoid")
    class ScaledSigmoidProp(pkg.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class ScaledSigmoid(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0],
                                pkg.nd.array(scale / (1 + np.exp(-x))))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y = out_data[0].asnumpy() / scale
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                pkg.nd.array(g * scale * y * (1 - y)))

            return ScaledSigmoid()


for _pkg in (mx, mt):
    _register_scaled_sigmoid(_pkg)


def _numpy_softmax(pkg):
    class NumpySoftmax(pkg.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x, y = in_data[0], out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab, y, dx = in_data[1], out_data[0], in_grad[0]
            dx[:] = y.copy()
            dx[np.arange(lab.shape[0]), lab.astype(np.int32)] -= 1.0

    return NumpySoftmax()


def _scale_op(pkg):
    class ScaleOp(pkg.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * 3.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3.0

    return ScaleOp()


def test_custom_op_imperative():
    x = np.random.RandomState(0).randn(3, 4).astype("f")
    want = mx.nd.Custom(mx.nd.array(x), op_type="port_test_scaled_sigmoid",
                        scale="2.0").asnumpy()
    with mt.cpu():
        got = mt.nd.Custom(mt.nd.array(x),
                           op_type="port_test_scaled_sigmoid",
                           scale="2.0").asnumpy()
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.sym.Custom(pkg.sym.Variable("data"),
                               op_type="port_test_scaled_sigmoid",
                               scale="1.5", name="cs"),
    lambda pkg: pkg.sym.FullyConnected(
        pkg.sym.Custom(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                              num_hidden=5, name="fc1"),
                       op_type="port_test_scaled_sigmoid", name="cs"),
        num_hidden=3, name="fc2")], ids=["alone", "between_layers"])
def test_custom_symbol_forward_backward(make):
    rng = np.random.RandomState(1)
    loc = {"data": rng.randn(4, 6).astype("f")}
    with mx.name.NameManager():
        names = make(mx).list_arguments()
    for n in names:
        if n != "data":
            shape = {"fc1_weight": (5, 6), "fc1_bias": (5,),
                     "fc2_weight": (3, 5), "fc2_bias": (3,)}[n]
            loc[n] = rng.randn(*shape).astype("f") * 0.5
    check_against_reference(make, loc, tol=1e-5)


@pytest.mark.parametrize("make,label", [(_numpy_softmax, True),
                                        (_scale_op, False)],
                         ids=["numpy_op", "ndarray_op"])
def test_legacy_ops_match_the_jax_package(make, label):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 4).astype("f")
    results = []
    for pkg in (mx, mt):
        net = make(pkg)(pkg.sym.Variable("data"), name="legacy")
        args = {"data": x}
        if label:
            lab_name = [n for n in net.list_arguments() if n != "data"][0]
            args[lab_name] = rng.randint(0, 4, (6,)).astype("f") \
                if pkg is mx else results[0][2]
        ctx = pkg.cpu()
        nd_args = {k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()}
        grads = {"data": pkg.nd.zeros(x.shape, ctx=ctx)}
        ex = net.bind(ctx, args=nd_args, args_grad=grads,
                      grad_req={"data": "write"})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.ones(x.shape, ctx=ctx)])
        results.append((out, grads["data"].asnumpy(),
                        args.get([n for n in args if n != "data"][0])
                        if label else None))
    (jo, jg, _), (to, tg, _) = results
    assert_close([to, tg], [jo, jg], 1e-5, "legacy op")


def test_backward_keeps_what_it_declared_and_honours_req_and_aux():
    """Two inputs, one without a gradient (req ``null``); a backward that
    declared only its outputs (the inputs arrive as None); an aux state
    the forward counts in."""
    seen = {}

    @mt.operator.register("port_test_declared")
    class DeclaredProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data", "other"]

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return list(out_grad) + list(out_data)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Declared(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * 2.0 + in_data[1])
                    aux[0][:] = aux[0] + 1.0

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    seen["req"] = list(req)
                    seen["in_data"] = list(in_data)
                    seen["out"] = out_data[0].asnumpy()
                    for i, r in enumerate(req):
                        self.assign(in_grad[i], r, out_grad[0] * 2.0)

            return Declared()

    x = np.arange(6, dtype="f").reshape(2, 3)
    with mt.cpu():
        data, other = mt.sym.Variable("data"), mt.sym.Variable("other")
        net = mt.sym.Custom(data, other, op_type="port_test_declared",
                            name="dec")
        assert net.list_auxiliary_states() == ["dec_count"]
        count = mt.nd.zeros((1,))
        grad = mt.nd.zeros((2, 3))
        ex = net.bind(mt.cpu(), args={"data": mt.nd.array(x),
                                      "other": mt.nd.ones((2, 3))},
                      args_grad={"data": grad},
                      grad_req={"data": "write", "other": "null"},
                      aux_states={"dec_count": count})
        ex.forward(is_train=True)
        ex.forward(is_train=True)
        ex.backward([mt.nd.ones((2, 3))])
    assert ex.aux_dict["dec_count"].asnumpy().tolist() == [2.0]
    assert seen["req"] == ["write", "null"]
    assert seen["in_data"] == [None, None]
    np.testing.assert_array_equal(seen["out"], x * 2 + 1)
    np.testing.assert_array_equal(grad.asnumpy(), np.full((2, 3), 2.0))
    op = mt.operator.CustomOp()
    dst = mt.nd.ones((2,), ctx=mt.cpu())
    op.assign(dst, "add", mt.nd.ones((2,), ctx=mt.cpu()))
    op.assign(dst, "null", mt.nd.zeros((2,), ctx=mt.cpu()))
    assert dst.asnumpy().tolist() == [2.0, 2.0]


def _custom_net(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = pkg.sym.Custom(h, op_type="port_test_scaled_sigmoid", scale="1.0",
                       name="cs")
    h = pkg.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("fused", ["never", "always"])
def test_custom_op_trains_through_fit(fused, monkeypatch):
    """A Custom node inside ``Module.fit``: the classic path, and the
    fused Trainer, which runs its steps uncaptured and names the node;
    both end where the JAX package's fit ends from the same start."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 6).astype("f")
    y = np.argmax(x @ rng.randn(6, 2), 1).astype("f")
    init = {"fc1_weight": rng.randn(8, 6).astype("f") * 0.4,
            "fc1_bias": np.zeros(8, "f"),
            "fc2_weight": rng.randn(2, 8).astype("f") * 0.4,
            "fc2_bias": np.zeros(2, "f")}
    params = []
    for pkg in (mx, mt):
        if pkg is mt:
            monkeypatch.setenv("MXTPU_MODULE_FUSED", fused)
        with pkg.cpu():
            it = pkg.io.NDArrayIter(x, y, batch_size=16)
            mod = pkg.mod.Module(_custom_net(pkg), context=pkg.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in init.items()})
            mod.fit(it, num_epoch=10, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5})
            it.reset()
            assert mod.score(it, "acc")[0][1] > 0.9
            params.append({k: v.asnumpy()
                           for k, v in mod.get_params()[0].items()})
        if pkg is mt and fused == "always":
            tr = mod._trainer
            assert tr.uncaptured == "Python bodies: cs (Custom[" \
                "port_test_scaled_sigmoid])"
            assert tr.graph_captures == 0
    want, got = params
    for k in init:
        assert rel_err(got[k], want[k]) <= 1e-4, k


def test_serving_a_custom_symbol_runs_it_eagerly():
    """Predictor and ModelServer serve a Custom tenant; its compiled
    forward records why it is never captured."""
    rng = np.random.RandomState(3)
    w = rng.randn(2, 8).astype("f")
    with mt.cpu():
        sym = _custom_net(mt)
        args = {"fc1_weight": mt.nd.array(rng.randn(8, 6).astype("f")),
                "fc1_bias": mt.nd.zeros((8,)),
                "fc2_weight": mt.nd.array(w), "fc2_bias": mt.nd.zeros((2,))}
        srv = mt.serving.ModelServer(buckets=[1, 4], max_wait_us=100,
                                     ctx=mt.cpu())
        srv.add_model("c", sym, args, {}, input_shapes={"data": (6,)})
        with srv:
            x = rng.randn(3, 6).astype("f")
            out = srv.predict(data=x, model="c")[0]
            st = srv.stats()
    reason = st["per_model"]["c"]["uncaptured"]
    assert reason == "Python bodies: cs (Custom[port_test_scaled_sigmoid])"
    with mx.name.NameManager():
        jsym = _custom_net(mx)
    jargs = {k: mx.nd.array(v.asnumpy()) for k, v in args.items()}
    jargs["data"] = mx.nd.array(x)
    jargs["softmax_label"] = mx.nd.zeros((3,))
    want = jsym.bind(mx.cpu(), args=jargs).forward()[0].asnumpy()
    assert rel_err(torch.as_tensor(out).numpy(), want) <= 1e-5
