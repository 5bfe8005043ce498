"""The port's TopKAccuracy, F1, MAE, MSE, RMSE, CustomMetric, ``np`` and
``create(callable)``, and its Orthogonal, MSRAPrelu and Bilinear
initializers, against the JAX package's on the CPU, with numpy inputs
from a seed.

Tolerances: a metric's value within 1e-6 of the JAX metric's (float32
sums in another order); the initializers draw from the same numpy stream
as the JAX package's, so their weights are compared bitwise, beside the
properties each promises (orthogonal rows at the given scale, Xavier's
moments at ``2 / (1 + slope^2)``, the bilinear kernel)."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt


def _pair(metric_of, labels, preds):
    """Both packages' metric over the same batches: (port, JAX) values."""
    got, want = metric_of(mt), metric_of(mx)
    for label, pred in zip(labels, preds):
        got.update([mt.nd.array(label, ctx=mt.cpu())],
                   [mt.nd.array(pred, ctx=mt.cpu())])
        want.update([mx.nd.array(label)], [mx.nd.array(pred)])
    return got.get(), want.get()


def _batches(n=3, rows=16, classes=6, seed=0):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, classes, rows).astype("f") for _ in range(n)],
            [rng.rand(rows, classes).astype("f") for _ in range(n)])


@pytest.mark.parametrize("make", [
    lambda m: m.metric.TopKAccuracy(top_k=3),
    lambda m: m.metric.create("top_k_accuracy", top_k=2),
    lambda m: m.metric.create(["accuracy", m.metric.create(
        "top_k_accuracy", top_k=5)]),
    lambda m: m.metric.F1(),
    lambda m: m.metric.create("mae"),
    lambda m: m.metric.MSE(),
    lambda m: m.metric.create("rmse"),
], ids=["top3", "create-top2", "composite", "f1", "mae", "mse", "rmse"])
def test_metrics_match_the_jax_package(make):
    labels, preds = _batches()
    if make(mt).name == "f1":
        labels, preds = _batches(classes=2, seed=1)
    if make(mt).name in ("mae", "mse", "rmse"):
        rng = np.random.RandomState(2)
        labels = [rng.rand(16).astype("f") for _ in range(3)]
        preds = [rng.rand(16, 1).astype("f") for _ in range(3)]
    (gn, gv), (wn, wv) = _pair(make, labels, preds)
    assert gn == wn
    np.testing.assert_allclose(gv, wv, rtol=1e-6)


def test_top_k_counts_membership_at_a_tie_on_the_kth_place():
    """Classes 1, 2 and 3 tie for the second place of a top-2: the label
    counts when it is class 0, and class 4 never does; ``torch.topk``
    picks one of the tied classes, as ``lax.top_k`` does (the JAX side
    keeps the lowest index, the port what ``torch.topk`` gives)."""
    pred = np.array([[0.9, 0.5, 0.5, 0.5, 0.1]] * 2, "f")
    for label, want in (([0, 4], 0.5), ([0, 0], 1.0), ([4, 4], 0.0)):
        (_, got), (_, jax) = _pair(lambda m: m.metric.TopKAccuracy(top_k=2),
                                   [np.array(label, "f")], [pred])
        assert got == jax == want
    # a tied class counts when the top k keeps it: both packages keep one
    # of the three, so one label in three of them is counted in each
    (_, got), (_, jax) = _pair(lambda m: m.metric.TopKAccuracy(top_k=2),
                               [np.array([1, 2, 3], "f")], [pred[[0] * 3]])
    assert got == jax == pytest.approx(1 / 3)


def test_top_k_of_one_raises_and_a_vector_prediction_is_a_class():
    with pytest.raises(mt.MXNetError, match="Accuracy"):
        mt.metric.TopKAccuracy(top_k=1)
    (_, got), (_, want) = _pair(lambda m: m.metric.TopKAccuracy(top_k=3),
                                [np.array([1, 2, 3], "f")],
                                [np.array([1, 0, 3], "f")])
    assert got == want == pytest.approx(2 / 3)


def test_custom_metrics_and_create_of_a_callable():
    def hits(label, pred):
        return float((pred.argmax(1) == label).sum()), label.size

    def mean_pred(label, pred):
        return float(pred.mean())

    labels, preds = _batches()
    for make in (lambda m: m.metric.create(hits),
                 lambda m: m.metric.np(mean_pred),
                 lambda m: m.metric.CustomMetric(lambda a, b: 0.5)):
        (gn, gv), (wn, wv) = _pair(make, labels, preds)
        assert gn == wn
        np.testing.assert_allclose(gv, wv, rtol=1e-6)
    assert mt.metric.create(hits).name == "hits"
    assert mt.metric.np(mean_pred, name="m").name == "m"
    assert mt.metric.CustomMetric(lambda a, b: 0).name == "custom(<lambda>)"


def _init_both(make, shape, name="x_weight", seed=7):
    mx.random.seed(seed)
    want = mx.nd.zeros(shape)
    make(mx)(mx.init.InitDesc(name), want)
    mt.random.seed(seed)
    got = mt.nd.zeros(shape, ctx=mt.cpu())
    make(mt)(mt.init.InitDesc(name), got)
    return got.asnumpy(), want.asnumpy()


@pytest.mark.parametrize("shape,rand_type", [((8, 20), "uniform"),
                                             ((16, 4, 2), "normal")])
def test_orthogonal_is_orthogonal_at_its_scale(shape, rand_type):
    got, want = _init_both(
        lambda m: m.init.Orthogonal(scale=1.5, rand_type=rand_type), shape)
    np.testing.assert_array_equal(got, want)
    flat = got.reshape(shape[0], -1).astype(np.float64)
    gram = flat @ flat.T if flat.shape[0] <= flat.shape[1] else flat.T @ flat
    np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(len(gram)),
                               atol=1e-5)


def test_msra_prelu_draws_xaviers_moments():
    shape = (64, 32, 3, 3)
    got, want = _init_both(lambda m: m.init.MSRAPrelu("in", slope=0.5),
                           shape)
    np.testing.assert_array_equal(got, want)
    std = np.sqrt(2.0 / (1 + 0.5 ** 2) / (32 * 9))
    assert abs(got.mean()) < 4 * std / np.sqrt(got.size)
    assert abs(got.std() / std - 1) < 0.02
    assert mt.init.MSRAPrelu(slope=0.5).dumps() == \
        mx.init.MSRAPrelu(slope=0.5).dumps()


def test_bilinear_is_the_upsampling_kernel():
    got, want = _init_both(lambda m: m.init.Bilinear(), (2, 3, 4, 4))
    np.testing.assert_array_equal(got, want)
    hat = np.array([0.25, 0.75, 0.75, 0.25], "f")
    np.testing.assert_array_equal(got[1, 2], np.outer(hat, hat))
    assert mt.init.create("bilinear").__class__ is mt.init.Bilinear


class _Two:
    """A metric over two outputs, as examples/multi-task's MultiAccuracy
    counts them in its own update."""

    @staticmethod
    def make(pkg):
        class MultiAccuracy(pkg.metric.EvalMetric):
            def __init__(self):
                super().__init__("multi-accuracy", num=2)

            def update(self, labels, preds):
                for i in range(self.num):
                    pred = preds[i].asnumpy().argmax(axis=1)
                    label = labels[i].asnumpy().astype("int32")
                    self.sum_metric[i] += float((pred == label).sum())
                    self.num_inst[i] += len(label)

        return MultiAccuracy()


def test_a_metric_counts_several_outputs_as_the_jax_package():
    """``EvalMetric(name, num=)``: list counters, ``get`` by ``name_i``,
    ``reset`` of each, and the base ``update`` refusing to count."""
    rng = np.random.RandomState(2)
    got, want = _Two.make(mt), _Two.make(mx)
    for _ in range(3):
        labels = [rng.randint(0, 3, 8).astype("f") for _ in range(2)]
        preds = [rng.rand(8, 3).astype("f") for _ in range(2)]
        got.update([mt.nd.array(x, ctx=mt.cpu()) for x in labels],
                   [mt.nd.array(x, ctx=mt.cpu()) for x in preds])
        want.update([mx.nd.array(x) for x in labels],
                    [mx.nd.array(x) for x in preds])
    assert got.get() == want.get()
    assert got.get()[0] == ["multi-accuracy_0", "multi-accuracy_1"]
    got.reset()
    want.reset()
    assert got.sum_metric == want.sum_metric == [0.0, 0.0]
    assert got.num_inst == want.num_inst == [0, 0]
    base = mt.metric.EvalMetric("m", num=2)
    with pytest.raises(NotImplementedError):
        base.update([mt.nd.zeros((2,), ctx=mt.cpu())],
                    [mt.nd.zeros((2, 3), ctx=mt.cpu())])
