"""The port's initializers, optimizers, schedulers, metrics, NDArrayIter
and training-mode Dropout against the JAX package's, on the CPU."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

# float32 updates, the same operations in the same order on both sides;
# python floats (the port) and float32 scalars (the JAX package) for lr,
# and the bias correction, round apart by an ulp or two a step
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _cpu(x):
    return mt.nd.array(np.asarray(x), ctx=mt.cpu())


@pytest.mark.parametrize("init,name,shape", [
    ("xavier_in", "fc_weight", (16, 10)),
    ("xavier_avg_gaussian", "fc_weight", (8, 4, 3, 3)),
    ("uniform", "fc_weight", (5, 7)),
    ("normal", "fc_weight", (5, 7)),
    ("constant", "fc_weight", (3,)),
    ("uniform", "fc_bias", (6,)),        # default rules by suffix
    ("uniform", "ln_gamma", (6,)),
    ("uniform", "ln_beta", (6,)),
    ("mixed", "head_weight", (4, 4)),
    ("mixed", "fc_weight", (4, 4)),
])
def test_initializers_draw_what_the_jax_package_draws(init, name, shape):
    def make(m):
        return {
            "xavier_in": lambda: m.init.Xavier(factor_type="in",
                                               magnitude=2.0),
            "xavier_avg_gaussian": lambda: m.init.Xavier(rnd_type="gaussian"),
            "uniform": lambda: m.init.Uniform(0.3),
            "normal": lambda: m.init.Normal(0.5),
            "constant": lambda: m.init.Constant(2.5),
            "mixed": lambda: m.init.Mixed(["head.*", ".*"],
                                          [m.init.Zero(), m.init.Normal(1.0)]),
        }[init]()

    mx.random.seed(7)
    want = mx.nd.zeros(shape)
    make(mx)(mx.init.InitDesc(name), want)
    mt.random.seed(7)
    got = mt.nd.zeros(shape, ctx=mt.cpu())
    make(mt)(mt.init.InitDesc(name), got)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_load_and_attr_init():
    src = {"arg:w_weight": _cpu(np.arange(6.0).reshape(2, 3))}
    arr = mt.nd.zeros((2, 3), ctx=mt.cpu())
    mt.init.Load(src)("w_weight", arr)
    np.testing.assert_array_equal(arr.asnumpy(), np.arange(6.0).reshape(2, 3))
    other = mt.nd.zeros((2,), ctx=mt.cpu())
    mt.init.Load(src, default_init=mt.init.One())("x_weight", other)
    np.testing.assert_array_equal(other.asnumpy(), [1, 1])
    with pytest.raises(mt.MXNetError, match="Cannot Initialize"):
        mt.init.Load(src)("x_weight", other)
    # a Variable's init attribute overrides the initializer's rule
    v = mt.sym.Variable("v_weight", init=mt.init.Constant(3.0))
    desc = mt.init.InitDesc("v_weight", v.attr_dict()["v_weight"])
    mt.init.Uniform()(desc, other)
    np.testing.assert_array_equal(other.asnumpy(), [3, 3])


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 rescale_grad=0.5, clip_gradient=0.3)),
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, beta1=0.8, wd=0.001,
                  rescale_grad=0.25, clip_gradient=1.0)),
])
def test_updates_match_the_jax_package_over_three_steps(name, kwargs):
    rng = np.random.RandomState(3)
    weights = {0: rng.randn(4, 5).astype("f"), 1: rng.randn(5).astype("f")}
    grads = [{i: rng.randn(*w.shape).astype("f") for i, w in weights.items()}
             for _ in range(3)]
    idx2name = {0: "fc_weight", 1: "fc_bias"}    # the bias decays at 0
    jup = mx.optimizer.get_updater(mx.optimizer.create(
        name, param_idx2name=idx2name, **kwargs))
    tup = mt.optimizer.get_updater(mt.optimizer.create(
        name, param_idx2name=idx2name, **kwargs))
    jw = {i: mx.nd.array(w) for i, w in weights.items()}
    tw = {i: _cpu(w) for i, w in weights.items()}
    for step in grads:
        for i, g in step.items():
            jup(i, mx.nd.array(g), jw[i])
            tup(i, _cpu(g), tw[i])
    for i in weights:
        np.testing.assert_allclose(tw[i].asnumpy(), jw[i].asnumpy(),
                                   **UPDATE_TOL)
    # states round-trip: a restored updater takes the same next step
    restored = mt.optimizer.get_updater(mt.optimizer.create(
        name, param_idx2name=idx2name, **kwargs))
    restored.set_states(tup.get_states())
    restored.optimizer._index_update_count = dict(
        tup.optimizer._index_update_count)
    restored.optimizer.num_update = tup.optimizer.num_update
    w2 = {i: w.copy() for i, w in tw.items()}
    for i, g in grads[0].items():
        tup(i, _cpu(g), tw[i])
        restored(i, _cpu(g), w2[i])
        np.testing.assert_array_equal(w2[i].asnumpy(), tw[i].asnumpy())


def test_lr_mult_from_symbol_and_schedulers():
    w = mt.sym.Variable("w_weight", lr_mult=0.5, wd_mult=2.0)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), weight=w,
                                num_hidden=2, name="fc")
    opt = mt.optimizer.SGD(learning_rate=1.0, wd=0.1, sym=net,
                           param_idx2name={0: "w_weight", 1: "fc_bias"})
    assert opt._get_lr(0) == 0.5 and opt._get_wd(0) == pytest.approx(0.2)
    assert opt._get_lr(1) == 1.0 and opt._get_wd(1) == 0.0
    for make in (lambda m: m.lr_scheduler.FactorScheduler(step=3, factor=0.5),
                 lambda m: m.lr_scheduler.MultiFactorScheduler([2, 5], 0.1),
                 lambda m: m.lr_scheduler.PolyScheduler(10, power=2)):
        js, ts = make(mx), make(mt)
        js.base_lr = ts.base_lr = 0.1
        assert [ts(n) for n in range(12)] == [js(n) for n in range(12)]
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    opt = mt.optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    weight = _cpu(np.zeros(1, "f"))
    for _ in range(3):
        opt.update(0, weight, _cpu(np.ones(1, "f")), None)
    # lr 1, 1, 0.5: the rate reads the count before each update
    np.testing.assert_allclose(weight.asnumpy(), [-2.5])


def test_metrics_match_the_jax_package():
    rng = np.random.RandomState(4)
    logits = rng.randn(12, 5).astype("f")
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.randint(0, 5, 12).astype("f")
    labels[:3] = 0
    for make in (lambda m: m.metric.Accuracy(),
                 lambda m: m.metric.Perplexity(None),
                 lambda m: m.metric.Perplexity(0),
                 lambda m: m.metric.CrossEntropy(),
                 lambda m: m.metric.create(["acc", "ce"]),
                 lambda m: m.metric.create("perplexity", ignore_label=None)):
        jm, tm = make(mx), make(mt)
        for lo, hi in ((0, 5), (5, 12)):
            jm.update([mx.nd.array(labels[lo:hi])],
                      [mx.nd.array(probs[lo:hi])])
            tm.update([_cpu(labels[lo:hi])], [_cpu(probs[lo:hi])])
        (jn, jv), (tn, tv) = jm.get(), tm.get()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        tm.reset()
        assert np.isnan(tm.get_name_value()[0][1])
    acc = mt.metric.Accuracy()
    acc.update([_cpu([1, 2, 3])], [_cpu([1, 0, 3])])    # class ids
    assert acc.get() == ("accuracy", 2 / 3)
    assert acc.sum_metric == 2 and acc.num_inst == 3


def test_perplexity_and_cross_entropy_take_a_negative_label():
    """A ``-1`` (padding) label counts from the last class, as the JAX
    package's ``take_along_axis`` does, and ``Perplexity(-1)`` then drops
    those rows; the port's ``gather`` raised on it (on the card, a
    device-side assert)."""
    rng = np.random.RandomState(0)
    pred = rng.rand(6, 5).astype("f")
    pred /= pred.sum(1, keepdims=True)
    labels = np.array([0, 1, 2, -1, 4, 1], "f")
    cases = [(lambda m: m.metric.Perplexity(-1), 2, 8.1557),
             (lambda m: m.metric.Perplexity(None), 2, 7.2911),
             (lambda m: m.metric.CrossEntropy(), 1, 2.0976)]
    for make, updates, value in cases:
        jm, tm = make(mx), make(mt)
        for rows in (6, 3)[:updates]:
            jm.update([mx.nd.array(labels[:rows])], [mx.nd.array(pred[:rows])])
            tm.update([_cpu(labels[:rows])], [_cpu(pred[:rows])])
        np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
        np.testing.assert_allclose(tm.get()[1], value, rtol=1e-4)


def test_ndarray_iter_shuffles_as_the_jax_package_does():
    x = np.arange(70, dtype="f").reshape(35, 2)
    y = np.arange(35, dtype="f")
    mx.random.seed(5)
    jit = mx.io.NDArrayIter(x, y, batch_size=8, shuffle=True)
    mt.random.seed(5)
    with mt.cpu():
        tit = mt.io.NDArrayIter(x, y, batch_size=8, shuffle=True)
    assert [d.shape for d in tit.provide_data] == [(8, 2)]
    assert tit.provide_label[0].name == "softmax_label"
    jb, tb = list(jit), list(tit)
    assert len(tb) == len(jb) == 5
    for j, t in zip(jb, tb):
        assert t.pad == j.pad
        np.testing.assert_array_equal(t.data[0].asnumpy(), j.data[0].asnumpy())
        np.testing.assert_array_equal(t.label[0].asnumpy(),
                                      j.label[0].asnumpy())
    tit.reset()
    assert next(iter(tit)).data[0].shape == (8, 2)
    with mt.cpu():
        assert len(list(mt.io.NDArrayIter(
            x, y, batch_size=8, last_batch_handle="discard"))) == 4


def test_training_dropout_moments_and_determinism():
    x = mt.nd.ones((200, 100), ctx=mt.cpu())
    assert mt.nd.Dropout(x, p=0.3).asnumpy().min() == 1.0     # predict mode
    with mt.autograd.train_mode():
        mt.random.seed(11)
        a = mt.nd.Dropout(x, p=0.3).asnumpy()
        b = mt.nd.Dropout(x, p=0.3).asnumpy()
        mt.random.seed(11)
        a2 = mt.nd.Dropout(x, p=0.3).asnumpy()
    np.testing.assert_array_equal(a, a2)            # deterministic per seed
    assert (a != b).any()
    kept = a != 0
    np.testing.assert_allclose(a[kept], 1 / 0.7, rtol=1e-6)
    # 20,000 Bernoulli(0.7) draws: the kept share within 4 sigma of 0.7
    assert abs(kept.mean() - 0.7) < 4 * np.sqrt(0.21 / kept.size)
    assert abs(a.mean() - 1.0) < 0.03
    assert mt.op.get("Dropout").mode_dependent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_divides_kept_elements_as_the_jax_package(dtype):
    """Every kept element is ``a / keep`` with ``keep`` rounded to the
    input's dtype, bitwise the JAX package's (masks differ by generator,
    so only the kept values are compared).  Multiplying by a rounded
    ``1 / keep`` was an ulp off on 26% (float32) and 61% (bfloat16) of
    them."""
    import jax.numpy as jnp
    x = np.random.RandomState(7).uniform(0.5, 1.5, 100000).astype("f")
    with mt.autograd.train_mode():
        out = mt.nd.Dropout(mt.nd.array(x, ctx=mt.cpu(), dtype=dtype),
                            p=0.1).asnumpy()
    want = np.asarray((jnp.asarray(x).astype(dtype) / 0.9)
                      .astype(jnp.float32))
    kept = out != 0
    assert 0.89 < kept.mean() < 0.91
    np.testing.assert_array_equal(out[kept], want[kept])


def test_dropout_in_the_executor_draws_a_mask_per_forward():
    data = mt.sym.Variable("data")
    net = mt.sym.Dropout(data, p=0.5, name="drop")
    exe = net.simple_bind(mt.cpu(), data=(64, 64))
    x = np.random.RandomState(6).rand(64, 64).astype("f") + 0.5
    mt.random.seed(2)
    out1 = exe.forward(is_train=True, data=x)[0].asnumpy()
    exe.backward(_cpu(np.ones((64, 64), "f")))
    grad = exe.grad_dict["data"].asnumpy()
    # the gradient is the same mask, scaled
    np.testing.assert_allclose(grad, (out1 != 0) * 2.0)
    out2 = exe.forward(is_train=True)[0].asnumpy()
    assert ((out1 != 0) != (out2 != 0)).any()
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(), x)


def test_ndarray_pickles_through_the_host():
    arr = _cpu(np.arange(4.0, dtype="f"))
    back = pickle.loads(pickle.dumps(arr))
    assert isinstance(back, mt.nd.NDArray) and back.grad is None
    np.testing.assert_array_equal(back.asnumpy(), arr.asnumpy())
    assert back.data.dtype == torch.float32


def test_ndarray_iter_on_the_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.io.NDArrayIter(np.zeros((4, 2), "f"), batch_size=2)
