"""FCN-xs on the port against the JAX package on the CPU: the fcn-xs
example's toy symbol and FCN-8s (upstream ``example/fcn-xs/
symbol_fcnxs.py``: VGG-16 with ``pad=(100, 100)`` on ``conv1_1``, fc6 a
7x7 and fc7 a 1x1 convolution, three ``Deconvolution`` upsamplings with
``adj = stride - 1`` and no bias, ``Crop`` at offsets (5, 5), (9, 9) and
(31, 31), a per-pixel ``SoftmaxOutput`` ignoring label 255) at widths cut
16x (fc 256) on 1x3x32x32, both built by one function from either
package's ``sym``.

The same weights (``fcn_weights``, numpy from a seed) and batch go
through both, bound by ``Symbol.bind``: every output and gradient within
1e-4 of the JAX side's largest magnitude (float32; a 13-layer float32
chain's sums in another order leave ~1e-6), then one step of each
package's own SGD (momentum 0.99, wd 5e-4, upstream ``fcn_xs.py``'s)
from those gradients, every weight within 1e-4.  Dropout is at p = 0
(the packages' generators draw other masks)."""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

import chip_smoke
from torch_parity import check_against_reference, both, rel_err

TOL = 1e-4
IGNORE = 255


def fcn8s(pkg, **kw):
    return chip_smoke.fcn8s_symbol(pkg.sym, **kw)


def _narrow(pkg):
    return fcn8s(pkg, widths=(4, 8, 16, 32, 32), fc=256, dropout=0.0)


def test_fcn8s_narrow_matches_jax_and_one_sgd_step():
    shape = (1, 3, 32, 32)
    x, y = chip_smoke.fcn_batch(shape, border=2)
    with mt.name.NameManager():
        weights = chip_smoke.fcn_params(_narrow(mt), shape)
    loc = dict(weights, data=x, softmax_label=y.astype(np.float32))
    port, want = check_against_reference(
        _narrow, loc, tol=TOL,
        grad_nodes=[n for n in weights])
    # one SGD step of each package's own optimizer from its gradients
    stepped = []
    for pkg, res in ((mx, want), (mt, port)):
        ctx = pkg.cpu()
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.99, wd=5e-4)
        out = {}
        for i, n in enumerate(sorted(weights)):
            w = pkg.nd.array(weights[n], ctx=ctx)
            g = pkg.nd.array(res["grads"][n], ctx=ctx)
            state = opt.create_state(i, w)
            opt.update(i, w, g, state)
            out[n] = w.asnumpy()
        stepped.append(out)
    for n in weights:
        assert rel_err(stepped[1][n], stepped[0][n]) <= TOL, n
    # the loss layer's gradient reaches every weight, and the outputs are
    # per-pixel distributions over 21 classes at the input's size
    probs = port["outputs"][0]
    assert probs.shape == (1, 21, 32, 32)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    assert all(np.abs(port["grads"][n]).max() > 0 for n in weights)


def test_fcn8s_infers_the_published_geometry():
    """At 1x3x500x500 with full widths both packages infer upstream's
    maps: score 15^2, score2 33^2, score4 69^2, bigscore 567^2, upscore
    500^2, and 134,489,759 parameters (shapes only, nothing allocated)."""
    shape = (1, 3, 500, 500)
    sizes = {}
    for pkg in (mx, mt):
        with pkg.name.NameManager():
            symbol = fcn8s(pkg)
        internals = symbol.get_internals()
        args, outs, _ = internals.infer_shape(data=shape)
        maps = dict(zip(internals.list_outputs(), outs))
        sizes[pkg.__name__] = (
            [maps[k][2:] for k in ("pool3_output", "pool4_output",
                                   "pool5_output", "score_output",
                                   "score2_output", "score4_output",
                                   "bigscore_output", "upscore_output")],
            sum(int(np.prod(s)) for n, s in
                zip(internals.list_arguments(), args)
                if n not in ("data", "softmax_label")))
    assert sizes["mxnet_tpu"] == sizes["mxnet_tpu_torch"]
    assert sizes["mxnet_tpu_torch"] == (
        [(87, 87), (43, 43), (21, 21), (15, 15), (33, 33), (69, 69),
         (567, 567), (500, 500)], 134489759)


def test_fcnxs_toy_matches_jax():
    """The fcn-xs example's toy symbol (``chip_smoke.py``'s symbol
    function; two classes, 32x32, ``normalization="valid"``) at batch
    2."""
    shape = (2, 3, 32, 32)
    def toy(pkg):
        return chip_smoke.fcnxs_toy_symbol(pkg.sym)

    with mt.name.NameManager():
        weights = chip_smoke.fcn_params(toy(mt), shape, seed=1)
    x, y = chip_smoke.fcn_batch(shape, 2, seed=1, border=0)
    check_against_reference(toy, dict(weights, data=x,
                                      softmax_label=y.astype(np.float32)),
                            tol=TOL, grad_nodes=list(weights))


def test_ignored_pixels_get_no_gradient():
    """The per-pixel softmax's gradient is exactly 0 at every pixel
    labelled 255 and equals the JAX package's elsewhere, under each
    normalization."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    _, label = chip_smoke.fcn_batch((2, 1, 6, 7), 5, seed=2, border=1)
    label = label.astype(np.float32)
    ignored = label == IGNORE
    assert 0 < ignored.mean() < 1
    for norm in ("null", "batch", "valid"):
        kw = dict(multi_output=True, use_ignore=True, ignore_label=IGNORE,
                  normalization=norm)
        (g_out, _, g_grads), (w_out, _, w_grads) = both(
            "SoftmaxOutput", kw, [data, label])
        assert rel_err(g_out[0], w_out[0]) <= 1e-6
        assert rel_err(g_grads[0], w_grads[0]) <= 1e-6
        grad = g_grads[0].transpose(0, 2, 3, 1)
        assert not grad[ignored].any()
        assert np.abs(grad[~ignored]).min() > 0
