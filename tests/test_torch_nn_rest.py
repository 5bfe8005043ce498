"""The rest of ``op/nn.py`` on the port against the JAX package's ops on
the CPU: LeakyReLU, the softmaxes, InstanceNorm, L2Normalization, the
loss layers (the regression outputs, SVMOutput, MakeLoss,
softmax_cross_entropy, IdentityAttachKLSparseReg), the Sequence ops and
UpSampling.  The same numpy inputs (from a seed) through both op bodies,
forward and backward with the same random head gradients (``jax.vjp``
beside ``torch.autograd.grad``), new aux states included, and through
both packages' shape inference.

Tolerance: float32, every array within 1e-5 of the JAX side's largest
magnitude (``torch_parity.rel_err``); what rounding leaves is ~1e-7.
A loss layer's injected gradient ignores the head gradient where the
JAX op does, so random head gradients check that too.  rrelu's training
draw comes from the port's generator (streams differ by design): its
slopes are checked by their bounds, mean and repeat per seed."""
import numpy as np
import pytest
import torch

from mxnet_tpu.op import registry as jreg
from mxnet_tpu_torch.op import registry as treg

from torch_parity import both, assert_close, port_apply

TOL = 1e-5


def _normal(*shape, scale=1.0):
    return lambda rng: (rng.standard_normal(shape) * scale).astype(np.float32)


def _uniform(lo, hi, *shape):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def _labels(hi, *shape):
    return lambda rng: rng.integers(0, hi, shape).astype(np.float32)


def _fixed(values):
    return lambda rng: np.asarray(values, np.float32)


# (name, op, params, input makers, aux makers)
CASES = [
    ("leaky", "LeakyReLU", {"act_type": "leaky", "slope": 0.1},
     [_normal(3, 4)], []),
    ("elu", "LeakyReLU", {"act_type": "elu", "slope": 0.7},
     [_normal(3, 4)], []),
    ("prelu", "LeakyReLU", {"act_type": "prelu"},
     [_normal(2, 3, 4), _uniform(0.1, 0.5, 3)], []),
    ("rrelu_eval_mean_slope", "LeakyReLU",
     {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3},
     [_normal(3, 4)], []),
    ("softmax_activation_instance", "SoftmaxActivation", {},
     [_normal(2, 3, 4)], []),
    ("softmax_activation_channel", "SoftmaxActivation", {"mode": "channel"},
     [_normal(2, 3, 4)], []),
    ("softmax_axis", "softmax", {"axis": 1}, [_normal(2, 3, 4)], []),
    ("softmax_temperature", "softmax", {"temperature": 2.5},
     [_normal(3, 5)], []),
    ("log_softmax_temperature", "log_softmax",
     {"axis": 0, "temperature": 0.5}, [_normal(3, 5)], []),
    ("log_softmax", "log_softmax", {}, [_normal(3, 5)], []),
    ("instance_norm", "InstanceNorm", {"eps": 1e-4},
     [_normal(2, 3, 4, 5), _uniform(0.5, 1.5, 3), _normal(3)], []),
    ("instance_norm_1d", "InstanceNorm", {},
     [_normal(2, 3, 6), _uniform(0.5, 1.5, 3), _normal(3)], []),
    ("l2_instance", "L2Normalization", {}, [_normal(2, 3, 4)], []),
    ("l2_channel", "L2Normalization", {"mode": "channel", "eps": 1e-3},
     [_normal(2, 3, 4)], []),
    ("l2_spatial", "L2Normalization", {"mode": "spatial"},
     [_normal(2, 3, 4, 2)], []),
    ("linear_regression", "LinearRegressionOutput", {"grad_scale": 2.0},
     [_normal(3, 4), _normal(3, 4)], []),
    ("linear_regression_column", "LinearRegressionOutput", {},
     [_normal(5, 1), _normal(5)], []),
    ("logistic_regression", "LogisticRegressionOutput", {},
     [_normal(3, 4), _uniform(0, 1, 3, 4)], []),
    ("mae_regression", "MAERegressionOutput", {"grad_scale": 0.5},
     [_normal(3, 2, 2), _normal(3, 2, 2)], []),
    ("svm_l2", "SVMOutput", {"margin": 0.8,
                             "regularization_coefficient": 1.5},
     [_normal(4, 5), _labels(5, 4)], []),
    ("svm_l1", "SVMOutput", {"use_linear": True},
     [_normal(4, 5), _labels(5, 4)], []),
    ("make_loss", "MakeLoss", {"grad_scale": 3.0}, [_normal(3, 4)], []),
    ("make_loss_batch", "MakeLoss", {"normalization": "batch"},
     [_normal(3, 4)], []),
    # "valid" is "null" and valid_thresh is never read, as in the JAX op
    ("make_loss_valid", "MakeLoss",
     {"normalization": "valid", "valid_thresh": 0.5}, [_normal(3, 4)], []),
    ("softmax_cross_entropy", "softmax_cross_entropy", {},
     [_normal(4, 6), _labels(6, 4)], []),
    ("kl_sparse_reg", "IdentityAttachKLSparseReg",
     {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.8},
     [_normal(3, 4)], [_fixed([0.3])]),
    ("sequence_last", "SequenceLast", {}, [_normal(4, 3, 2)], []),
    ("sequence_last_lengths", "SequenceLast",
     {"use_sequence_length": True},
     [_normal(4, 3, 2), _fixed([1, 4, 2])], []),
    ("sequence_mask", "SequenceMask", {}, [_normal(4, 3, 2)], []),
    ("sequence_mask_lengths", "SequenceMask",
     {"use_sequence_length": True, "value": -2.0},
     [_normal(4, 3, 2), _fixed([1, 4, 2])], []),
    ("sequence_reverse", "SequenceReverse", {}, [_normal(4, 3, 2)], []),
    ("sequence_reverse_lengths", "SequenceReverse",
     {"use_sequence_length": True},
     [_normal(4, 3, 2, 2), _fixed([1, 4, 3])], []),
    ("upsampling_nearest", "UpSampling",
     {"scale": 3, "sample_type": "nearest"}, [_normal(2, 3, 2, 4)], []),
    # bilinear: every edge pixel included, the taps past the image
    # dropped and the rest renormalised (jax.image.resize)
    ("upsampling_bilinear", "UpSampling",
     {"scale": 2, "sample_type": "bilinear"}, [_normal(1, 2, 3, 5)], []),
    ("upsampling_bilinear_x4", "UpSampling",
     {"scale": 4, "sample_type": "bilinear"}, [_normal(1, 1, 4, 3)], []),
    ("upsampling_sum", "UpSampling",
     {"scale": 2, "num_args": 2, "multi_input_mode": "sum"},
     [_normal(1, 2, 3, 3), _normal(1, 2, 4, 4)], []),
    ("upsampling_concat", "UpSampling", {"scale": 2, "num_args": 2},
     [_normal(1, 2, 3, 3), _normal(1, 1, 3, 3)], []),
]


@pytest.mark.parametrize("name,op,params,makers,aux",
                         CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(name, op, params, makers, aux):
    rng = np.random.default_rng(0)
    ins = [m(rng) for m in makers]
    auxs = [m(rng) for m in aux]
    (g_out, g_aux, g_grads), (w_out, w_aux, w_grads) = both(
        op, params, ins, auxs, is_train=not name.startswith("rrelu"))
    assert_close(g_out, w_out, TOL, name + " outputs")
    assert_close(g_aux, w_aux, TOL, name + " aux")
    assert_close(g_grads, w_grads, TOL, name + " gradients")
    j_op, t_op = jreg.get(op), treg.get(op)
    shapes = [a.shape for a in ins]
    j_in, j_out, j_aux = j_op.infer_shape_generic(
        j_op.parse_params(dict(params)), shapes)
    t_in, t_out, t_aux = t_op.infer_shape_generic(
        t_op.parse_params(dict(params)), shapes)
    assert [tuple(s) for s in t_in] == [tuple(s) for s in j_in]
    assert [tuple(s) for s in t_out] == [tuple(s) for s in j_out] \
        == [o.shape for o in g_out]
    assert [tuple(s) for s in t_aux] == [tuple(s) for s in j_aux]


def test_loss_layers_ignore_the_head_gradient():
    """SVMOutput, MakeLoss and the regressions return the same input
    gradient for any head gradient; the label gets none."""
    rng = np.random.default_rng(4)
    for op, kw, ins in (
            ("SVMOutput", {}, [rng.standard_normal((3, 4)),
                               rng.integers(0, 4, 3)]),
            ("MakeLoss", {}, [rng.standard_normal((3, 4))]),
            ("LinearRegressionOutput", {}, [rng.standard_normal((3, 2)),
                                            rng.standard_normal((3, 2))])):
        ins = [np.asarray(a, np.float32) for a in ins]
        grads = [port_apply(op, kw, ins, cots=[c])[2]
                 for c in (np.ones((3,) + ins[0].shape[1:], np.float32),
                           rng.standard_normal(ins[0].shape)
                           .astype(np.float32) * 7)]
        np.testing.assert_array_equal(grads[0][0], grads[1][0])
        assert all(not g.any() for g in grads[0][1:])


def _rrelu(seed, is_train=True):
    gen = torch.Generator().manual_seed(seed)
    x = np.full((200, 300), -1.0, np.float32)
    out, _, _ = port_apply("LeakyReLU", {"act_type": "rrelu",
                                         "lower_bound": 0.125,
                                         "upper_bound": 0.334}, [x],
                           is_train=is_train, rng=gen)
    return -out[0]


def test_rrelu_draws_its_slopes_from_the_generator():
    """In training each negative element gets a slope uniform in
    ``[lower_bound, upper_bound)``, the same per seed, others for
    another; in evaluation the bounds' mean."""
    slopes = _rrelu(0)
    assert slopes.min() >= 0.125 and slopes.max() < 0.334
    assert abs(slopes.mean() - (0.125 + 0.334) / 2) < 2e-3
    assert abs(slopes.std() - (0.334 - 0.125) / np.sqrt(12)) < 2e-3
    np.testing.assert_array_equal(slopes, _rrelu(0))
    assert (slopes != _rrelu(1)).mean() > 0.99
    np.testing.assert_allclose(_rrelu(0, is_train=False),
                               (0.125 + 0.334) / 2, rtol=1e-7)
    positive = port_apply("LeakyReLU", {"act_type": "rrelu"},
                          [np.ones((4,), np.float32)], is_train=True,
                          rng=torch.Generator().manual_seed(0))[0][0]
    np.testing.assert_array_equal(positive, 1.0)


def test_kl_sparse_reg_updates_its_average_inside_the_op():
    """The moving average is an aux output of the op's own forward (so a
    captured step carries it), momentum toward mean(sigmoid(data))."""
    x = np.random.default_rng(1).standard_normal((5, 6)).astype(np.float32)
    _, new_aux, _ = port_apply("IdentityAttachKLSparseReg",
                               {"momentum": 0.9}, [x],
                               [np.array([0.5], np.float32)])
    rho_hat = (1 / (1 + np.exp(-x))).mean()
    np.testing.assert_allclose(new_aux[0], [0.5 * 0.9 + rho_hat * 0.1],
                               rtol=1e-6)
