"""The port's Convolution, Pooling, BatchNorm and ReLU against the JAX
package's ops on the CPU: the same numpy inputs (from a seed) through
both registries' op bodies, forward and backward (``jax.vjp`` beside
``torch.autograd.grad``), outputs, new aux states and every input's
gradient compared.

Tolerances: float32 on both sides with sums in another order, the
largest difference within 2e-5 of the largest magnitude of the JAX
side's array (what rounding leaves is ~1e-6; a wrong formula is off by
far more than 1e-3); bfloat16, the difference's norm within 2e-2 of the
JAX side's (bfloat16's epsilon is 7.8e-3, XLA may skip rounding between
fused operations where PyTorch rounds after each, and the JAX package's
sums of bfloat16 gradients (eval-mode gamma) accumulate in bfloat16).  Max pooling
on integer-valued inputs with exact ties is compared bitwise in
float32, forward and backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.op import bytediet as jbd
from mxnet_tpu.op import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.op import bytediet as tbd
from mxnet_tpu_torch.op import nn as tnn
from mxnet_tpu_torch.op import registry as treg

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_apply(name, kw, ins, aux=(), is_train=True, cots=None,
               dtype="float32", policy=None):
    """The JAX op on ``ins`` (+ ``aux``): (outputs, new aux, gradients of
    ``ins`` for the cotangents ``cots`` of the outputs), as float32
    numpy."""
    op = jreg.get(name)
    p = op.parse_params(dict(kw))
    ctx = jreg.OpContext(is_train=is_train, dtype_policy=policy)

    @jax.jit
    def run(xs, aux_j, cots):
        (outs, new_aux), vjp = jax.vjp(
            lambda *v: op.apply(p, ctx, *v, *aux_j), *xs)
        if cots is None:
            return outs, new_aux, ()
        return outs, new_aux, vjp((tuple(
            c.astype(o.dtype) for c, o in zip(cots, outs)),
            tuple(jnp.zeros_like(a) for a in new_aux)))

    outs, new_aux, grads = run(
        [jnp.asarray(a).astype(dtype) for a in ins],
        [jnp.asarray(a).astype(dtype) for a in aux],
        None if cots is None else [jnp.asarray(c) for c in cots])

    def host(vals):
        return [np.asarray(v.astype(jnp.float32)) for v in vals]

    return host(outs), host(new_aux), host(grads)


def _port_apply(name, kw, ins, aux=(), is_train=True, cots=None,
                dtype="float32", policy=None):
    """The port's op on the same inputs, with torch autograd."""
    op = treg.get(name)
    p = op.parse_params(dict(kw))
    ctx = treg.OpContext(is_train=is_train, record=True, dtype_policy=policy)
    dt = _TORCH_DT[dtype]
    xs = [torch.from_numpy(np.ascontiguousarray(a)).to(dt).requires_grad_()
          for a in ins]
    aux_t = [torch.from_numpy(a).to(dt) for a in aux]
    outs, new_aux = op.apply(p, ctx, *xs, *aux_t)
    grads = []
    if cots is not None:
        heads = [(o, torch.from_numpy(c).to(o.dtype))
                 for o, c in zip(outs, cots) if o.requires_grad]
        got = torch.autograd.grad([h for h, _ in heads], xs,
                                  [c for _, c in heads], allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, got)]

    def host(vals):
        return [v.detach().float().numpy() for v in vals]

    return host(outs), host(new_aux), host(grads)


def _close(got, want, tol, what):
    """float32 (``tol`` below 1e-3): the largest difference against the
    largest magnitude; bfloat16: the difference's norm against the
    norm."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if tol < 1e-3:
            err = float(np.abs(g - w).max())
            scale = max(float(np.abs(w).max()), 1.0)
        else:
            err = float(np.linalg.norm(g - w))
            scale = max(float(np.linalg.norm(w)), 1.0)
        assert err <= tol * scale, "%s[%d]: %g > %g" % (what, i, err,
                                                         tol * scale)


def _both(name, kw, ins, aux=(), is_train=True, dtype="float32",
          policy=None, seed=1):
    """Run both ops with the same random cotangents; returns (port, jax)."""
    outs, _, _ = _jax_apply(name, kw, ins, aux, is_train, None, dtype,
                            policy)
    rng = np.random.default_rng(seed)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    want = _jax_apply(name, kw, ins, aux, is_train, cots, dtype, policy)
    got = _port_apply(name, kw, ins, aux, is_train, cots, dtype, policy)
    return got, want


# ----------------------------------------------------------------------
# Convolution
CONV_CASES = {
    "2d_nchw_pad_bias": ((2, 3, 9, 9), dict(kernel=(3, 3), num_filter=4,
                                            pad=(1, 1))),
    "2d_nhwc_stride_pad": ((2, 10, 9, 3), dict(
        kernel=(3, 3), num_filter=5, stride=(2, 2), pad=(1, 2),
        no_bias=True, layout="NHWC")),
    "2d_nhwc_dilate_groups_bias": ((2, 9, 9, 4), dict(
        kernel=(3, 3), num_filter=6, dilate=(2, 2), num_group=2,
        layout="NHWC")),
    "2d_nhwc_1x1": ((2, 5, 5, 8), dict(kernel=(1, 1), num_filter=4,
                                       no_bias=True, layout="NHWC")),
    "2d_nhwc_stem_7x7_s2": ((2, 16, 16, 3), dict(
        kernel=(7, 7), num_filter=4, stride=(2, 2), pad=(3, 3),
        no_bias=True, layout="NHWC", workspace=512, cudnn_tune="fastest",
        cudnn_off=True)),
    "1d_ncw_stride": ((2, 3, 11), dict(kernel=(3,), num_filter=4,
                                       stride=(2,), pad=(1,))),
    "1d_nwc_groups": ((2, 11, 6), dict(kernel=(3,), num_filter=6,
                                       num_group=3, layout="NWC")),
    "3d_ncdhw_pad": ((1, 2, 5, 6, 5), dict(kernel=(3, 3, 3), num_filter=3,
                                           pad=(1, 1, 1), layout="NCDHW")),
    "3d_ndhwc_stride_bias": ((1, 6, 5, 6, 2), dict(
        kernel=(2, 3, 2), num_filter=3, stride=(2, 1, 2),
        layout="NDHWC")),
}


def _conv_inputs(dshape, kw, seed=0):
    sym = mx.sym.Convolution(mx.sym.Variable("data"), name="c", **kw)
    shapes, _, _ = sym.infer_shape(data=dshape)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    dshape, kw = CONV_CASES[case]
    got, want = _both("Convolution", kw, _conv_inputs(dshape, kw))
    for g, w, what in zip(got, want, ("outputs", "aux", "grads")):
        _close(g, w, TOL["float32"], "%s %s" % (case, what))


def test_convolution_bfloat16_nhwc_matches_jax():
    dshape, kw = CONV_CASES["2d_nhwc_stride_pad"]
    got, want = _both("Convolution", kw, _conv_inputs(dshape, kw),
                      dtype="bfloat16")
    for g, w, what in zip(got, want, ("outputs", "aux", "grads")):
        _close(g, w, TOL["bfloat16"], what)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_infer_shape_matches_jax(case):
    dshape, kw = CONV_CASES[case]
    want = mx.sym.Convolution(mx.sym.Variable("data"), name="c",
                              **kw).infer_shape(data=dshape)
    got = mt.sym.Convolution(mt.sym.Variable("data"), name="c",
                             **kw).infer_shape(data=dshape)
    assert [[tuple(s) for s in part] for part in got] \
        == [[tuple(s) for s in part] for part in want]


def test_convolution_rejects_an_unknown_layout():
    conv = mt.sym.Convolution(mt.sym.Variable("data"), kernel=(3, 3),
                              num_filter=2, layout="HWCN")
    with pytest.raises(MXNetError, match="layout"):
        conv.infer_shape(data=(1, 4, 4, 3))


def test_float32_convolutions_turn_tf32_off_and_restore_the_flag():
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        with tnn._exact_float32(torch.float32):
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is True
        with tnn._exact_float32(torch.bfloat16):
            assert cudnn.allow_tf32 is True
        cudnn.allow_tf32 = False
        with tnn._exact_float32(torch.float32):
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is False
        # a forward and backward through the op leave the caller's flag
        cudnn.allow_tf32 = True
        dshape, kw = CONV_CASES["2d_nhwc_1x1"]
        _port_apply("Convolution", kw, _conv_inputs(dshape, kw),
                    cots=[np.ones((2, 5, 5, 4), np.float32)])
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = saved


# ----------------------------------------------------------------------
# Pooling
POOL_CASES = {
    "max_3x3_s2_p1_nhwc_stem": ((2, 9, 9, 3), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
        layout="NHWC")),
    "max_2x2_s2_nchw": ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2))),
    "max_3x3_s2_full": ((2, 3, 8, 7), dict(
        kernel=(3, 3), stride=(2, 2), pooling_convention="full")),
    "max_pad_past_half_kernel": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(1, 1), pad=(2, 2))),
    "max_3x3_s2_p1_full_nhwc": ((2, 8, 8, 2), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        pooling_convention="full", layout="NHWC")),
    "max_global_nchw": ((2, 3, 5, 4), dict(kernel=(1, 1), global_pool=True)),
    "max_1d_full": ((2, 3, 10), dict(kernel=(3,), stride=(2,),
                                     pooling_convention="full")),
    "max_3d_ndhwc": ((1, 5, 4, 5, 2), dict(kernel=(2, 2, 2), stride=(2, 1, 2),
                                           layout="NDHWC", pool_type="max")),
    "avg_3x3_s1_p1_nchw": ((2, 3, 7, 7), dict(
        kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg")),
    "avg_3x3_s2_full_nhwc": ((2, 8, 8, 3), dict(
        kernel=(3, 3), stride=(2, 2), pooling_convention="full",
        pool_type="avg", layout="NHWC")),
    "avg_pad_past_half_kernel": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(2, 1), pool_type="avg")),
    "avg_global_nhwc_7x7": ((2, 7, 7, 4), dict(
        kernel=(7, 7), global_pool=True, pool_type="avg", layout="NHWC")),
    "avg_1d_nwc": ((2, 9, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                   pool_type="avg", layout="NWC")),
    "avg_3d_full": ((1, 2, 5, 6, 5), dict(
        kernel=(2, 2, 2), stride=(2, 2, 2), pool_type="avg",
        pooling_convention="full")),
    "sum_2x2_s1_p1_nhwc": ((2, 6, 6, 3), dict(
        kernel=(2, 2), stride=(1, 1), pad=(1, 1), pool_type="sum",
        layout="NHWC")),
    "sum_global_nchw": ((2, 3, 4, 4), dict(kernel=(1, 1), global_pool=True,
                                           pool_type="sum")),
}


def _ties(shape, seed=0):
    """Integer-valued inputs from {0, 1, 2}: overlapping windows hold
    exact ties of their maximum."""
    return np.random.default_rng(seed).integers(0, 3, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    dshape, kw = POOL_CASES[case]
    x = _ties(dshape)
    got, want = _both("Pooling", kw, [x])
    if kw.get("pool_type", "max") == "max":
        # the first maximum of each window takes the whole cotangent,
        # overlapping windows add there, all-padding windows drop theirs:
        # bitwise, under both of the JAX package's formulations
        for g, w in zip(got[0] + got[2], want[0] + want[2]):
            np.testing.assert_array_equal(g, w)
        _, _, legacy = _jax_apply("Pooling", kw, [x], cots=[
            np.random.default_rng(1).standard_normal(want[0][0].shape)
            .astype(np.float32)], policy="legacy")
        np.testing.assert_array_equal(got[2][0], legacy[0])
    else:
        for g, w, what in zip(got, want, ("outputs", "aux", "grads")):
            _close(g, w, TOL["float32"], "%s %s" % (case, what))
    shapes = mt.sym.Pooling(mt.sym.Variable("data"), **kw) \
        .infer_shape(data=dshape)
    assert shapes[1] == [want[0][0].shape]


def test_max_pool_gradient_goes_to_the_first_maximum():
    # one 2x2 window holding four equal values: the top-left one (the
    # smallest linear index) takes the cotangent
    x = np.ones((1, 1, 2, 2), np.float32)
    _, _, grads = _port_apply("Pooling", dict(kernel=(2, 2)), [x],
                              cots=[np.full((1, 1, 1, 1), 3.0, np.float32)])
    np.testing.assert_array_equal(grads[0][0, 0], [[3.0, 0.0], [0.0, 0.0]])


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pooling_bfloat16_nhwc_matches_jax(pool_type):
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool_type,
              layout="NHWC")
    x = np.random.default_rng(3).standard_normal((2, 9, 9, 4)) \
        .astype(np.float32)
    got, want = _both("Pooling", kw, [x], dtype="bfloat16")
    for g, w, what in zip(got, want, ("outputs", "aux", "grads")):
        _close(g, w, TOL["bfloat16"], what)


def test_pooling_v1_is_pooling():
    assert treg.get("Pooling_v1") is treg.get("Pooling")


# ----------------------------------------------------------------------
# ReLU: torch.relu's autograd is the JAX package's relu_save_output
def test_relu_backward_is_the_output_mask_bitwise():
    x = (np.random.default_rng(4).integers(-2, 3, (4, 6)) * 0.5) \
        .astype(np.float32)            # exact zeros among the inputs
    g = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = torch.relu(xt)
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    for fn in (jbd.relu_save_output, jax.nn.relu):
        yj, vjp = jax.vjp(fn, jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(yj))
        np.testing.assert_array_equal(gt.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))
    assert (gt.numpy()[x == 0] == 0).all()


# ----------------------------------------------------------------------
# BatchNorm
def _bn_inputs(dshape, axis, far, seed=0):
    """(data, gamma, beta) and the aux (moving_mean, moving_var).  ``far``
    puts the running mean far from the batch mean (data near 10, running
    mean 0), where the single-pass variance cancels and the guard takes
    the two-pass statistics; else the running mean sits near the batch
    mean and the single pass stands."""
    rng = np.random.default_rng(seed)
    c = dshape[axis]
    data = rng.standard_normal(dshape).astype(np.float32)
    if far:
        data = 10.0 + 0.5 * data
        mmean = np.zeros(c, np.float32)
    else:
        data = 3.0 + 2.0 * data
        axes = tuple(i for i in range(len(dshape)) if i != axis)
        mmean = (data.mean(axes) + 0.1 * rng.standard_normal(c)) \
            .astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    mvar = (1.0 + rng.random(c)).astype(np.float32)
    return [data, gamma, beta], [mmean, mvar]


def _guard_fires(data, center, axis):
    axes = tuple(i for i in range(data.ndim) if i != axis)
    xc = data.astype(np.float64) - center.reshape(
        [-1 if i == axis else 1 for i in range(data.ndim)])
    d1, d2 = xc.mean(axes), (xc * xc).mean(axes)
    return bool((d1 * d1 > 63.0 / 64.0 * d2).any())


BN_CASES = {
    # name: (data shape, params, is_train, dtype, far)
    "train_nhwc_axis3_near": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False,
                                                 eps=2e-5), True,
                              "float32", False),
    "train_nhwc_axis3_far": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False,
                                                eps=2e-5), True,
                             "float32", True),
    "train_nchw_axis1_fix_gamma_near": ((4, 6, 5, 5), dict(), True,
                                        "float32", False),
    "train_nchw_axis1_fix_gamma_far": ((4, 6, 5, 5), dict(), True,
                                       "float32", True),
    "train_2d_axis1": ((16, 7), dict(fix_gamma=False, momentum=0.8), True,
                       "float32", False),
    "train_output_mean_var_near": ((4, 6, 3, 3), dict(
        fix_gamma=False, output_mean_var=True), True, "float32", False),
    "train_output_mean_var_far": ((4, 5, 5, 6), dict(
        axis=3, output_mean_var=True), True, "float32", True),
    "train_use_global_stats": ((4, 6, 3, 3), dict(
        fix_gamma=False, use_global_stats=True), True, "float32", False),
    "eval_nhwc": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False), False,
                  "float32", False),
    "eval_output_mean_var": ((4, 6, 3, 3), dict(output_mean_var=True),
                             False, "float32", False),
    "train_bf16_nhwc_near": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False,
                                                eps=2e-5), True,
                             "bfloat16", False),
    "train_bf16_nhwc_far": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False,
                                               eps=2e-5), True,
                            "bfloat16", True),
    "train_bf16_nchw_fix_gamma": ((4, 6, 5, 5), dict(), True, "bfloat16",
                                  False),
    "eval_bf16_nhwc": ((4, 5, 5, 6), dict(axis=3, fix_gamma=False), False,
                       "bfloat16", False),
}


@pytest.mark.parametrize("policy", ["bytediet", "legacy"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_matches_jax(case, policy):
    dshape, kw, is_train, dtype, far = BN_CASES[case]
    axis = kw.get("axis", 1)
    ins, aux = _bn_inputs(dshape, axis, far)
    if is_train and not kw.get("use_global_stats"):
        assert _guard_fires(ins[0], aux[0], axis) == far
    got, want = _both("BatchNorm", kw, ins, aux, is_train, dtype, policy)
    for g, w, what in zip(got, want, ("outputs", "moving stats", "grads")):
        _close(g, w, TOL[dtype], "%s %s" % (case, what))
    if kw.get("fix_gamma", True):
        assert not got[2][1].any()       # gamma held at one: no gradient


def test_batchnorm_guard_changes_the_variance():
    """Where the guard fires, the single-pass variance would be off: the
    port's (two-pass) variance matches float64's, the single pass's does
    not."""
    dshape, axis = (4, 5, 5, 6), 3
    ins, aux = _bn_inputs(dshape, axis, far=True)
    data = torch.from_numpy(ins[0])
    center = torch.from_numpy(aux[0])
    _, var32 = tbd.bn_batch_stats(data, center, (0, 1, 2))
    exact = ins[0].astype(np.float64).var((0, 1, 2))
    xc = data - center
    d1, d2 = xc.mean((0, 1, 2)), (xc * xc).mean((0, 1, 2))
    single = (d2 - d1 * d1).numpy()
    assert np.abs(var32.numpy() - exact).max() < 1e-5
    assert np.abs(single - exact).max() > 10 * np.abs(
        var32.numpy() - exact).max()


def test_batchnorm_infer_shape_matches_jax():
    for kw in (dict(axis=3), dict(output_mean_var=True)):
        want = mx.sym.BatchNorm(mx.sym.Variable("data"), name="bn", **kw)
        got = mt.sym.BatchNorm(mt.sym.Variable("data"), name="bn", **kw)
        assert got.list_outputs() == want.list_outputs()
        assert got.list_auxiliary_states() == want.list_auxiliary_states()
        assert [[tuple(s) for s in part]
                for part in got.infer_shape(data=(2, 3, 4, 5))] \
            == [[tuple(s) for s in part]
                for part in want.infer_shape(data=(2, 3, 4, 5))]


def test_unknown_dtype_policy_raises(monkeypatch):
    monkeypatch.setenv("MXTPU_DTYPE_POLICY", "Legacy")
    with pytest.raises(ValueError, match="dtype_policy"):
        jbd.enabled(None)
    with pytest.raises(ValueError, match="dtype_policy"):
        tbd.enabled(None)
    ins, aux = _bn_inputs((4, 3), 1, False)
    with pytest.raises(ValueError, match="dtype_policy"):
        _port_apply("BatchNorm", {}, ins, aux)
    with mt.cpu(), pytest.raises(MXNetError, match="dtype_policy"):
        mt.parallel.Trainer(mt.models.get_symbol("mlp"),
                            mt.optimizer.SGD(), dtype_policy="byte-diet")


def test_legacy_policy_from_the_environment(monkeypatch):
    """``MXTPU_DTYPE_POLICY=legacy`` selects autograd through the plain
    BatchNorm expression in both packages, with the same numbers."""
    monkeypatch.setenv("MXTPU_DTYPE_POLICY", "legacy")
    assert not tbd.enabled(None) and not jbd.enabled(None)
    dshape, kw, _, _, _ = BN_CASES["train_nhwc_axis3_far"]
    ins, aux = _bn_inputs(dshape, 3, True)
    got, want = _both("BatchNorm", kw, ins, aux)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"], "legacy")
    with mt.cpu():
        t = mt.parallel.Trainer(
            mt.models.get_symbol("resnet-8", num_classes=2,
                                 image_shape=(3, 8, 8)),
            mt.optimizer.SGD(learning_rate=0.1))
    assert t.prog.dtype_policy == "legacy"


def test_batchnorm_negative_axis_is_the_last_axis():
    """``axis=-1`` normalises over the last axis, as ``axis=2`` does on 3-D
    data, matching the JAX op at ``axis=2`` (the JAX op fails on a
    negative axis: ROADMAP.md §C)."""
    ins, aux = _bn_inputs((4, 3, 5), 2, False)
    kw = dict(fix_gamma=False)
    got, _ = _both("BatchNorm", dict(kw, axis=2), ins, aux)
    neg = _port_apply("BatchNorm", dict(kw, axis=-1), ins, aux,
                      cots=[np.random.default_rng(1).standard_normal(
                          (4, 3, 5)).astype(np.float32)])
    for g, n in zip(got, neg):
        for a, b in zip(g, n):
            np.testing.assert_array_equal(a, b)
