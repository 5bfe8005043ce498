"""The port's vision and contrib ops (``op/vision.py``, ``op/contrib.py``)
against the JAX package's on the CPU: the golden cases of
``tests/test_vision_contrib.py`` through both op bodies, forward and
backward with the same random head gradients (``jax.vjp`` beside
``torch.autograd.grad``), every output and gradient within 1e-5 of the
JAX side's largest magnitude (``torch_parity.rel_err``; the ops gather,
compare and sum a few terms), and each case's own golden values on the
port's output (the identity SpatialTransformer samples at whole pixels,
where the bilinear weights have a kink, so only its output is held).
The detection ops run at small versions of the networks they come
from: Proposal over a 6 x 8 RPN map with 9 anchors,
ROIPooling at spatial scale 1/16 with several rois, and the MultiBox
family over 5 x 5 and 3 x 3 maps of 2 images with padded labels."""
import numpy as np
import pytest

import mxnet_tpu_torch as mt

from torch_parity import assert_close, both

TOL = 1e-5


def _identity_grid(n, h, w):
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    return np.stack([xs, ys], 0)[None].repeat(n, axis=0).astype(np.float32)


def _ssd_maps(rng, n=2, classes=4):
    """A 5 x 5 and a 3 x 3 map's anchors (3 each), class scores and
    offsets, and labels of 3 slots, the last padded with -1."""
    anchors = []
    for size, (h, w) in ((0.3, (5, 5)), (0.6, (3, 3))):
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        for r in (1.0, 2.0, 0.5):
            bw, bh = size * np.sqrt(r) / 2, size / np.sqrt(r) / 2
            anchors.append(np.stack([xs - bw, ys - bh, xs + bw, ys + bh],
                                    -1).reshape(-1, 4))
    anchors = np.concatenate(anchors)[None].astype(np.float32)
    A = anchors.shape[1]
    label = np.full((n, 3, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(2 - i % 2):
            x0, y0 = rng.uniform(0.05, 0.5, 2)
            label[i, j] = [rng.integers(0, classes - 1), x0, y0,
                           x0 + rng.uniform(0.2, 0.45),
                           y0 + rng.uniform(0.2, 0.45)]
    logits = rng.standard_normal((n, classes, A)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.standard_normal((n, A * 4)) * 0.3).astype(np.float32)
    return anchors, label, prob.astype(np.float32), loc


def _rpn(rng, n=1, h=6, w=8, scales=(2.0, 4.0, 8.0),
         ratios=(0.5, 1.0, 2.0)):
    k = len(scales) * len(ratios)
    logits = rng.standard_normal((n, 2, k, h, w)).astype(np.float32)
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .reshape(n, 2 * k, h, w).astype(np.float32)
    deltas = (rng.standard_normal((n, 4 * k, h, w)) * 0.1) \
        .astype(np.float32)
    info = np.tile(np.array([[h * 16, w * 16, 1.0]], np.float32), (n, 1))
    return prob, deltas, info


def _cases():
    rng = np.random.default_rng(0)
    r = np.random.RandomState(0)
    data = r.rand(2, 3, 5, 7).astype(np.float32)
    d6 = np.random.RandomState(1).rand(2, 2, 6, 6).astype(np.float32)
    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    anchors, label, prob, loc = _ssd_maps(rng)
    feat = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    rois = np.array([[0, 0, 0, 255, 191], [1, 32, 16, 200, 150],
                     [0, 100, 60, 110, 70], [1, 0, 0, 15, 15],
                     [0, 48.4, 40.6, 240.2, 180.7]], np.float32)
    corr = np.random.RandomState(2).rand(1, 4, 6, 6).astype(np.float32)
    return [
        ("BilinearSampler", {}, [data, _identity_grid(2, 5, 7)],
         lambda o: np.testing.assert_allclose(o[0], data, rtol=1e-5,
                                              atol=1e-5)),
        ("BilinearSampler", {},
         [data, (r.rand(2, 2, 4, 6).astype(np.float32) * 2.4 - 1.2)],
         None),
        ("SpatialTransformer", {"target_shape": (6, 6)}, [d6, theta],
         lambda o: np.testing.assert_allclose(o[0], d6, rtol=1e-5,
                                              atol=1e-5)),
        ("SpatialTransformer", {"target_shape": (4, 5)},
         [d6, theta + r.randn(2, 6).astype(np.float32) * 0.1], None),
        ("GridGenerator", {"transform_type": "affine",
                           "target_shape": (4, 5)}, [theta],
         lambda o: np.testing.assert_allclose(
             o[0][0, 0, 0], np.linspace(-1, 1, 5), rtol=1e-5, atol=1e-5)),
        ("GridGenerator", {"transform_type": "warp"},
         [r.randn(2, 2, 3, 4).astype(np.float32)], None),
        ("ROIPooling", {"pooled_size": (2, 2), "spatial_scale": 1.0},
         [np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4),
          np.array([[0, 0, 0, 3, 3]], np.float32)],
         lambda o: np.testing.assert_allclose(
             o[0], [[[[5, 7], [13, 15]]]])),
        ("ROIPooling", {"pooled_size": (3, 3), "spatial_scale": 0.0625},
         [feat, rois], None),
        ("Correlation", {"kernel_size": 1, "max_displacement": 1,
                         "stride1": 1, "stride2": 1, "pad_size": 1},
         [corr, corr],
         lambda o: np.testing.assert_allclose(
             o[0][0, 4][1:-1, 1:-1], (corr[0] ** 2).mean(0)[1:-1, 1:-1],
             rtol=1e-4, atol=1e-5)),
        ("Correlation", {"kernel_size": 3, "max_displacement": 2,
                         "stride1": 2, "stride2": 2, "pad_size": 2,
                         "is_multiply": False},
         [corr, np.random.RandomState(3).rand(1, 4, 6, 6)
          .astype(np.float32)], None),
        ("MultiBoxPrior", {"sizes": "(0.5,)", "ratios": "(1.0, 2.0)"},
         [np.zeros((1, 3, 4, 4), np.float32)],
         lambda o: np.testing.assert_allclose(
             o[0][0, 0], [0.125 - .25, 0.125 - .25, 0.125 + .25,
                          0.125 + .25], rtol=1e-5, atol=1e-6)),
        ("MultiBoxPrior", {"sizes": "(0.2, 0.4)", "ratios": "(1, 2, 0.5)",
                           "clip": True, "steps": "(0.1, 0.125)"},
         [np.zeros((1, 3, 5, 4), np.float32)], None),
        ("MultiBoxTarget", {},
         [np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                     [0.0, 0.5, 0.5, 1.0]]], np.float32),
          np.array([[[2, 0.01, 0.01, 0.48, 0.52], [-1, 0, 0, 0, 0]]],
                   np.float32), np.zeros((1, 4, 3), np.float32)],
         lambda o: (o[2][0, 0] == 3.0 and o[1][0, :4].sum() == 4.0
                    and o[2][0, 1] == 0.0) or pytest.fail(str(o))),
        ("MultiBoxTarget", {"negative_mining_ratio": 1.0,
                            "negative_mining_thresh": 0.5,
                            "overlap_threshold": 0.6},
         [np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                     [0.15, 0.0, 0.65, 0.5], [0.0, 0.6, 0.4, 1.0]]],
                   np.float32),
          np.array([[[1, 0.0, 0.0, 0.5, 0.5]]], np.float32),
          np.array([[[.9, .1, .9, .9], [.1, .9, .1, .1]]], np.float32)],
         lambda o: np.testing.assert_array_equal(o[2][0],
                                                 [2, 0, -1, -1])),
        ("MultiBoxTarget", {"negative_mining_ratio": 3.0,
                            "minimum_negative_samples": 2},
         [anchors, label, prob], None),
        ("MultiBoxDetection", {"threshold": 0.5},
         [np.array([[[0.1, 0.2], [0.9, 0.8]]], np.float32),
          np.zeros((1, 8), np.float32),
          np.array([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]],
                   np.float32)],
         lambda o: np.testing.assert_allclose(sorted(o[0][0, :, 1]),
                                              [0.8, 0.9], atol=1e-6)),
        ("MultiBoxDetection", {"nms_threshold": 0.45, "threshold": 0.2},
         [prob, loc, anchors], None),
        ("MultiBoxDetection", {"force_suppress": True, "nms_topk": 20,
                               "clip": False}, [prob, loc, anchors], None),
        ("Proposal", {"feature_stride": 16, "scales": "(8.0,)",
                      "ratios": "(0.5,1.0,2.0)", "rpn_pre_nms_top_n": 12,
                      "rpn_post_nms_top_n": 5, "rpn_min_size": 0},
         [r.rand(1, 6, 4, 4).astype(np.float32),
          (r.rand(1, 12, 4, 4).astype(np.float32) - 0.5) * 0.1,
          np.array([[64, 64, 1.0]], np.float32)],
         lambda o: (o[0].shape == (5, 5) and (o[0][:, 0] == 0).all()
                    and (o[0][:, 1:] >= 0).all()
                    and (o[0][:, 1:] <= 63).all()) or pytest.fail(str(o))),
        ("Proposal", {"scales": "(2.0, 4.0, 8.0)", "rpn_pre_nms_top_n": 200,
                      "rpn_post_nms_top_n": 30, "rpn_min_size": 4,
                      "output_score": True}, list(_rpn(rng, n=2)), None),
        ("count_sketch", {"out_dim": 2},
         [np.array([[1., 2., 3.]], np.float32),
          np.array([0, 1, 0], np.float32), np.array([1, -1, 1], np.float32)],
         lambda o: np.testing.assert_allclose(o[0], [[4., -2.]])),
        ("fft", {}, [r.rand(3, 8).astype(np.float32)], None),
        ("ifft", {}, [r.rand(3, 16).astype(np.float32)], None),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    name, params, ins, golden = case
    (got, _, ggrad), (want, _, wgrad) = both(name, params, ins,
                                             is_train=True, jit=True)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert_close(got, want, TOL, name + " outputs")
    if name != "SpatialTransformer" or golden is None:
        # the identity transform samples at whole pixels, where the
        # bilinear weights have a kink: its gradient is not defined
        assert_close(ggrad, wgrad, TOL, name + " gradients")
    if golden is not None:
        golden(got)


def test_fft_ifft_roundtrip():
    x = np.random.RandomState(4).rand(3, 8).astype(np.float32)
    with mt.cpu():
        f = mt.nd.fft(mt.nd.array(x))
        back = mt.nd.contrib.ifft(f).asnumpy()
    assert f.shape == (3, 16)
    np.testing.assert_allclose(back, x * 8, rtol=1e-4, atol=1e-4)


def test_the_contrib_names_and_shapes():
    """``_contrib_*`` aliases, ``mx.sym.contrib``/``mx.nd.contrib``, and
    shape inference of the symbols the SSD and R-CNN networks build."""
    s = mt.sym
    assert s.contrib.MultiBoxPrior is not None and mt.nd.contrib.Proposal
    data = s.Variable("data")
    prior = s.contrib.MultiBoxPrior(data, sizes="(0.2, 0.3)",
                                    ratios="(1, 2, 0.5)")
    _, out, _ = prior.infer_shape(data=(2, 8, 38, 38))
    assert out == [(1, 38 * 38 * 4, 4)]
    prop = s._contrib_Proposal(s.Variable("cls"), s.Variable("bbox"),
                               s.Variable("info"), output_score=True)
    _, out, _ = prop.infer_shape(cls=(1, 18, 38, 50), bbox=(1, 36, 38, 50),
                                 info=(1, 3))
    assert out == [(300, 5), (300, 1)]
    roi = s.ROIPooling(s.Variable("feat"), s.Variable("rois"),
                       pooled_size=(7, 7), spatial_scale=0.0625)
    _, out, _ = roi.infer_shape(feat=(1, 512, 38, 50), rois=(128, 5))
    assert out == [(128, 512, 7, 7)]
