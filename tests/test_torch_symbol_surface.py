"""The port's Symbol, Executor and NDArray surface against the JAX
package's on the CPU: ``Symbol.__iter__``/``__len__``, copy and
deepcopy, the comparison operators, ``list_inputs``, ``attr``,
``get_children``, ``eval`` and ``grad``; ``Executor.partial_forward``,
``debug_str`` and ``group2ctx`` on one device; ``NDArray.wait_to_write``;
the ``mt.nd.contrib``/``mt.sym.contrib`` namespaces; and the port's
``test_utils`` harness.

Values are float32 on both sides and compared within 1e-6 of the JAX
side's largest magnitude (small graphs; rounding leaves ~1e-7); graphs
are compared by their JSON, text by equality."""
import copy

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError

from torch_parity import rel_err

TOL = 1e-6
CONTRIB = {"DotProductAttention", "MultiBoxPrior", "MultiBoxTarget",
           "MultiBoxDetection", "Proposal", "count_sketch", "fft", "ifft"}


def _net(pkg):
    data = pkg.sym.Variable("data", attr={"mood": "calm"})
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    bn = pkg.sym.BatchNorm(fc, name="bn", fix_gamma=False)
    act = pkg.sym.Activation(bn, act_type="tanh", name="act")
    return pkg.sym.Group([pkg.sym.softmax(act, name="sm"), fc])


def _both(fn):
    with mx.name.NameManager():
        j = fn(mx)
    with mt.name.NameManager():
        t = fn(mt)
    return j, t


def _bound(pkg, sym, seed=0):
    rng = np.random.default_rng(seed)
    ctx = pkg.cpu()
    shapes, _, aux_shapes = sym.infer_shape(data=(3, 5))
    args = {n: pkg.nd.array(rng.standard_normal(s).astype(np.float32),
                            ctx=ctx)
            for n, s in zip(sym.list_arguments(), shapes)}
    aux = {n: pkg.nd.array(np.full(s, 0.5 if "var" in n else 0.1,
                                   np.float32), ctx=ctx)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym.bind(ctx, args=args, aux_states=aux)


def test_iteration_length_copies_and_children():
    j, t = _both(_net)
    assert len(t) == len(j) == 2
    assert [s.list_outputs() for s in t] == [s.list_outputs() for s in j]
    assert t.list_inputs() == j.list_inputs() == [
        "data", "fc_weight", "fc_bias", "bn_gamma", "bn_beta",
        "bn_moving_mean", "bn_moving_var"]
    for jc, tc in ((copy.copy(j), copy.copy(t)),
                   (copy.deepcopy(j), copy.deepcopy(t))):
        assert tc.tojson() == jc.tojson() == t.tojson()
    deep = copy.deepcopy(t)
    assert deep._outputs[0][0] is not t._outputs[0][0]
    assert copy.copy(t)._outputs[0][0] is t._outputs[0][0]
    assert t[0].get_children().list_outputs() \
        == j[0].get_children().list_outputs() == ["act_output"]
    assert t[1].get_children().list_outputs() \
        == j[1].get_children().list_outputs() \
        == ["data", "fc_weight", "fc_bias"]
    assert mt.sym.Variable("x").get_children() is None
    data = t[1].get_children()[0]
    assert data.attr("mood") == j[1].get_children()[0].attr("mood") == "calm"
    assert data.attr("absent") is None and t.attr("mood") is None


def test_comparison_operators_build_the_jax_graph():
    def cmp(pkg):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        return pkg.sym.Group([a > b, a >= 0.5, a < b, a <= -0.25,
                              2.0 < a])

    j, t = _both(cmp)
    assert t.tojson() == j.tojson()
    rng = np.random.default_rng(1)
    vals = {n: rng.integers(-1, 2, (3, 4)).astype(np.float32) * 0.5
            for n in ("a", "b")}
    with mt.cpu():
        got = t.eval(mt.cpu(), **{n: mt.nd.array(v) for n, v in vals.items()})
    want = j.eval(mx.cpu(), **{n: mx.nd.array(v) for n, v in vals.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_eval_and_grad():
    def net(pkg):
        x = pkg.sym.Variable("x")
        return pkg.sym.sum(pkg.sym.square(x) * 2.0 + 1.0, axis=1)

    j, t = _both(net)
    x = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    got = t.eval(mt.cpu(), x=mt.nd.array(x, ctx=mt.cpu()))
    want = j.eval(mx.cpu(), x=mx.nd.array(x))
    assert len(got) == len(want) == 1
    assert rel_err(got[0].asnumpy(), want[0].asnumpy()) <= TOL
    for sym, err in ((t, MXNetError), (j, mx.base.MXNetError)):
        with pytest.raises(err, match="deprecated"):
            sym.grad(["x"])


def test_partial_forward_walks_the_nodes_in_order():
    j, t = _both(_net)
    tex, jex = _bound(mt, t), _bound(mx, j)
    full = [o.asnumpy() for o in tex.forward(is_train=False)]
    steps = []
    for ex in (tex, jex):
        step = 0
        while ex.partial_forward(is_train=False, step=step):
            step += 1
        steps.append(step + 1)
    assert steps[0] == steps[1] == 4
    for g, w, f in zip(tex.outputs, jex.outputs, full):
        assert rel_err(g.asnumpy(), w.asnumpy()) <= TOL
        np.testing.assert_array_equal(g.asnumpy(), f)
    # "done" right after a walk; a step out of order raises, and a
    # walk's outputs have no backward
    assert tex.partial_forward(step=4) == 0
    with pytest.raises(MXNetError, match="in order"):
        tex.partial_forward(step=2)
    tex.partial_forward(step=0)
    with pytest.raises(MXNetError, match="in order"):
        tex.partial_forward(step=3)
    with pytest.raises(MXNetError):
        tex.backward()


def test_partial_forward_in_training_updates_aux_at_the_end():
    j, t = _both(_net)
    tex, jex = _bound(mt, t), _bound(mx, j)
    for ex in (tex, jex):
        before = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
        step = 0
        while ex.partial_forward(is_train=True, step=step):
            if step < 3:
                np.testing.assert_array_equal(
                    ex.aux_dict["bn_moving_mean"].asnumpy(), before)
            step += 1
    for n in tex.aux_dict:
        assert rel_err(tex.aux_dict[n].asnumpy(),
                       jex.aux_dict[n].asnumpy()) <= TOL, n
    assert rel_err(tex.outputs[0].asnumpy(), jex.outputs[0].asnumpy()) <= TOL


def test_debug_str_is_the_jax_packages():
    j, t = _both(_net)
    assert _bound(mt, t).debug_str() == _bound(mx, j).debug_str()
    text = _bound(mt, t).debug_str().splitlines()
    assert text[0] == "Symbol outputs: sm_output, fc_output"
    assert "Op:BatchNorm, Name=bn, out=[float32 (3, 4)]" in text


def test_group2ctx_on_one_device():
    t = _net(mt)
    with mt.cpu():
        ex = t.simple_bind(mt.cpu(), data=(3, 5),
                           group2ctx={"stage1": mt.cpu(), "stage2": mt.cpu()})
        assert ex.forward()[0].shape == (3, 4)
        for bind in (lambda g: t.simple_bind(mt.cpu(), data=(3, 5),
                                             group2ctx=g),
                     lambda g: t.bind(mt.cpu(), args=ex.arg_dict,
                                      aux_states=ex.aux_dict, group2ctx=g)):
            with pytest.raises(MXNetError, match="ROADMAP item 5"):
                bind({"stage1": mt.cpu(), "stage2": mt.gpu(0)})


def test_wait_to_write_and_contrib_namespaces():
    with mt.cpu():
        a = mt.nd.ones((2, 3))
    assert a.wait_to_write() is None and a.wait_to_read() is None
    jax_contrib = {n for n in vars(mx.sym.contrib)}
    assert set(vars(mt.sym.contrib)) == jax_contrib \
        == set(vars(mt.nd.contrib)) == CONTRIB
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
               for _ in range(3))
    with mt.cpu():
        got = mt.nd.contrib.DotProductAttention(
            mt.nd.array(q), mt.nd.array(k), mt.nd.array(v))
    want = mx.nd.contrib.DotProductAttention(
        mx.nd.array(q), mx.nd.array(k), mx.nd.array(v))
    assert rel_err(got.asnumpy(), want.asnumpy()) <= 1e-5
    s = mt.sym.contrib.DotProductAttention(
        mt.sym.Variable("q"), mt.sym.Variable("k"), mt.sym.Variable("v"))
    assert s.list_arguments() == ["q", "k", "v"]


def test_the_harness_checks_gradients_and_catches_a_wrong_one():
    """``check_numeric_gradient`` passes a Deconvolution-and-Crop graph
    and fails a loss layer's injected gradient (which is no derivative of
    its forward); ``check_symbolic_forward``/``backward`` and
    ``assert_almost_equal`` hold their contracts."""
    rng = np.random.RandomState(0)
    with mt.cpu():
        data = mt.sym.Variable("data")
        up = mt.sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2),
                                  adj=(1, 1), num_filter=2, no_bias=True,
                                  name="up")
        net = mt.sym.Crop(up, h_w=(4, 4), offset=(1, 2), num_args=1)
        tu.check_numeric_gradient(
            net, {"data": rng.randn(1, 2, 3, 3).astype("f"),
                  "up_weight": rng.randn(2, 2, 3, 3).astype("f")},
            numeric_eps=1e-2, rtol=1e-2, atol=1e-3)
        with pytest.raises(AssertionError):
            tu.check_numeric_gradient(
                mt.sym.MakeLoss(data * 3.0),
                {"data": rng.randn(2, 3).astype("f")}, numeric_eps=1e-2)
        x = rng.randn(2, 3).astype("f")
        tu.check_symbolic_forward(mt.sym.log_softmax(data), {"data": x},
                                  [x - np.log(np.exp(x).sum(1,
                                                            keepdims=True))],
                                  rtol=1e-5, atol=1e-6)
        tu.check_symbolic_backward(mt.sym.BlockGrad(data) + data * 2.0,
                                   {"data": x}, [np.ones_like(x)],
                                   {"data": np.full_like(x, 2.0)})
        assert tu.simple_forward(mt.sym.sort(data), data=x).shape == (2, 3)
        with pytest.raises(AssertionError, match="Error"):
            tu.assert_almost_equal(x, x + 1e-3, rtol=1e-6, atol=1e-6)
