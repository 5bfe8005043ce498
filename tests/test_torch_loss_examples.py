"""The loss-layer examples on the port.

Their symbols (examples/autoencoder, svm_mnist, nce-loss, recommenders
and dec; fcn-xs's is in ``test_torch_fcn.py``), made by
``chip_smoke.py``'s symbol functions from either package's ``sym``,
bound to the same numpy inputs on the CPU, forward and backward against
the JAX package: every output and gradient within 1e-5 of the JAX side's
largest magnitude (float32, a few small products).  Then ``chip_smoke.py``'s loss_examples runs, on the port's
CPU, each at its own size, on the classic path and on the fused step:
each must pass its example's own assert.  A user's metric that counts in
its own ``update`` (the nce example's) works as in the JAX package, and
the fused step reads a dict-fed batch by name (the recommender's)."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

import chip_smoke
from torch_parity import check_against_reference

TOL = 1e-5


# each example's symbol from chip_smoke's symbol function (which takes
# either package's ``sym``), and the shapes of its inputs
EXAMPLES = {
    "autoencoder": (lambda pkg: chip_smoke.autoencoder_symbol(
        pkg.sym, (32, 8), 64), dict(data=(8, 64), label=(8, 64))),
    "svm": (lambda pkg: chip_smoke.svm_symbol(pkg.sym),
            dict(data=(8, 20), svm_label=(8,))),
    "svm_linear": (lambda pkg: chip_smoke.svm_symbol(pkg.sym, True),
                   dict(data=(8, 20), svm_label=(8,))),
    "nce": (lambda pkg: chip_smoke.nce_symbol(pkg.sym),
            dict(data=(8, 20), label=(8, 6), label_weight=(8, 6))),
    "matrix_fact": (lambda pkg: chip_smoke.matrix_fact_symbol(pkg.sym),
                    dict(user=(8, 1), item=(8, 1), score_label=(8, 1))),
    "dec": (lambda pkg: chip_smoke.dec_symbol(pkg.sym),
            dict(data=(8, 16), p_label=(8, 3))),
}


def _location(name, seed=0):
    """Random weights and inputs for every argument of the example's
    symbol: ids in range for the Embeddings, probabilities for labels
    that are distributions, N(0, 1) (times 0.3 for weights) for the
    rest."""
    fn, shapes = EXAMPLES[name]
    rng = np.random.default_rng(seed)
    with mt.name.NameManager():
        s = fn(mt)
    args, _, _ = s.infer_shape(**shapes)
    loc = {}
    for n, shape in zip(s.list_arguments(), args):
        if n == "svm_label":
            loc[n] = rng.integers(0, 4, shape).astype(np.float32)
        elif n == "label" and name == "nce":
            loc[n] = rng.integers(0, 100, shape).astype(np.float32)
        elif n in ("user", "item"):
            loc[n] = rng.integers(0, 30, shape).astype(np.float32)
        elif n in ("label_weight", "p_label"):
            loc[n] = rng.dirichlet(np.ones(shape[1]), shape[0]) \
                .astype(np.float32)
        else:
            scale = 0.3 if n.endswith("_weight") else 1.0
            loc[n] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return loc


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_symbol_matches_jax(name):
    loc = _location(name)
    grads = [n for n in loc if n.endswith(("_weight", "_bias"))
             or n == "data"]
    port, _ = check_against_reference(EXAMPLES[name][0], loc, tol=TOL,
                                      grad_nodes=grads)
    assert all(np.isfinite(o).all() for o in port["outputs"])


@pytest.mark.parametrize("fused", ["never", "always"])
@pytest.mark.parametrize("name,fn", chip_smoke.LOSS_EXAMPLES,
                         ids=[n for n, _ in chip_smoke.LOSS_EXAMPLES])
def test_example_passes_its_own_assert_on_the_cpu(name, fn, fused):
    """On the classic path and on the fused step (run eagerly here, a
    CUDA graph on the card)."""
    score, ok, params, _ = chip_smoke.run_example(fn, mt.cpu(), fused)
    assert ok, (name, score)
    assert params and all(np.isfinite(v.numpy()).all()
                          for v in params.values())


def test_a_metric_counts_in_its_own_update():
    """``sum_metric`` and ``num_inst`` take writes, as the JAX package's
    do: a user's metric that adds to them in ``update`` (the nce example's
    NceAccuracy) reports the same value in both packages."""
    def metric_class(pkg):
        class Hits(pkg.metric.EvalMetric):
            def __init__(self):
                super().__init__("hits")

            def update(self, labels, preds):
                scores, weight = preds[0].asnumpy(), labels[0].asnumpy()
                self.sum_metric += (scores.argmax(1)
                                    == weight.argmax(1)).sum()
                self.num_inst += scores.shape[0]
        return Hits

    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, 3)).astype(np.float32),
                rng.standard_normal((4, 3)).astype(np.float32))
               for _ in range(3)]
    values = []
    for pkg in (mx, mt):
        m = metric_class(pkg)()
        for s, w in batches:
            m.update([pkg.nd.array(w, ctx=pkg.cpu())],
                     [pkg.nd.array(s, ctx=pkg.cpu())])
        values.append(m.get())
        m.reset()
        assert (m.sum_metric, m.num_inst) == (0.0, 0)
    assert values[0] == values[1]
    assert values[1][1] == sum((s.argmax(1) == w.argmax(1)).sum()
                               for s, w in batches) / 12


def _mf_fit(fused):
    """One epoch of two batches of the recommender's symbol through
    ``Module.fit`` on the CPU, fed a dict whose sorted order (item, user)
    is not ``data_names``'s (user, item)."""
    mt.random.seed(0)
    rng = np.random.RandomState(0)
    with chip_smoke._fused_policy(fused), mt.cpu():
        it = mt.io.NDArrayIter(
            {"user": rng.randint(0, 40, (128, 1)).astype("f"),
             "item": rng.randint(0, 30, (128, 1)).astype("f")},
            {"score_label": rng.randn(128, 1).astype("f")},
            batch_size=64)
        mod = mt.mod.Module(chip_smoke.matrix_fact_symbol(mt.sym),
                            data_names=("user", "item"),
                            label_names=("score_label",))
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": 0.02},
                initializer=mt.init.Normal(0.3))
        assert (mod._trainer is not None) == (fused == "always")
        return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_the_fused_step_reads_a_batch_by_its_bound_names():
    """The fused path takes a batch's arrays in the order of the shapes
    the module was bound with (the iterator's ``provide_data``), as the
    classic path does, not in ``data_names``'s order: with a dict-fed
    iterator the two paths train the same rows (Adam, one epoch, within
    1e-5; swapping user and item ids moved other rows, 8e-2 apart)."""
    classic, fused = _mf_fit("never"), _mf_fit("always")
    for n in classic:
        err = np.linalg.norm(fused[n] - classic[n]) \
            / np.linalg.norm(classic[n])
        assert err <= 1e-5, (n, err)
