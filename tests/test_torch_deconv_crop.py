"""The port's Deconvolution and Crop against the JAX package's on the CPU:
the same numpy inputs (from a seed) through both registries' op bodies,
forward and backward (``jax.vjp`` beside ``torch.autograd.grad``), and
through both packages' shape inference.

Tolerance: float32 on both sides, every output and gradient within 1e-5
of the JAX side's largest magnitude (``torch_parity.rel_err``; sums in
another order leave ~1e-6, a wrong tap or flip is off by far more).
Two defects of the JAX package's ``_deconv_infer_shape`` are pinned:
it leaves ``dilate`` out (so it disagrees with its own op's output) and
ignores ``target_shape``, which the port ignores too."""
import numpy as np
import pytest

from mxnet_tpu.op import registry as jreg
from mxnet_tpu_torch.op import registry as treg

from torch_parity import both, assert_close

TOL = 1e-5

# (data shape, params); weights are (C, num_filter / num_group, *kernel)
DECONV_CASES = {
    "1d_stride_pad_adj_bias": ((2, 3, 5), dict(
        kernel=(3,), stride=(2,), pad=(1,), adj=(1,), num_filter=4)),
    "2d_groups_dilate": ((2, 4, 4, 5), dict(
        kernel=(3, 3), stride=(2, 2), dilate=(2, 1), num_group=2,
        num_filter=6)),
    "2d_fcn_upscore_4x4_s2": ((1, 3, 5, 5), dict(
        kernel=(4, 4), stride=(2, 2), adj=(1, 1), num_filter=3,
        no_bias=True)),
    # adj >= stride: cuDNN refuses it as output_padding; the port cuts the
    # unpadded result to the JAX op's window and pads zeros past its end
    "2d_adj_at_stride_pad": ((2, 2, 4, 3), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 2), adj=(2, 3),
        num_filter=3)),
    "2d_adj_past_stride_no_pad": ((1, 2, 3, 3), dict(
        kernel=(2, 2), stride=(1, 1), adj=(2, 1), num_filter=2)),
    "2d_nhwc_stride_adj": ((2, 5, 4, 4), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0),
        num_filter=3, layout="NHWC")),
    "2d_nhwc_groups_dilate_adj_past": ((1, 4, 4, 4), dict(
        kernel=(2, 3), stride=(1, 2), dilate=(2, 1), adj=(2, 1),
        num_group=2, num_filter=4, layout="NHWC")),
    "3d_stride_pad": ((1, 2, 3, 4, 3), dict(
        kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 0), num_filter=3)),
    "3d_ndhwc_adj": ((1, 3, 3, 2, 2), dict(
        kernel=(2, 2, 2), stride=(2, 2, 2), adj=(1, 0, 1), num_filter=2,
        no_bias=True, layout="NDHWC")),
}


def _deconv_inputs(dshape, kw, seed=0):
    """Data, weight and (unless ``no_bias``) bias from a seed."""
    rng = np.random.default_rng(seed)
    nd = len(kw["kernel"])
    last = kw.get("layout", "NCHW").upper() in ("NWC", "NHWC", "NDHWC")
    cin = dshape[-1] if last else dshape[1]
    wshape = (cin, kw["num_filter"] // kw.get("num_group", 1)) \
        + tuple(kw["kernel"])
    ins = [rng.standard_normal(dshape).astype(np.float32),
           rng.standard_normal(wshape).astype(np.float32)]
    if not kw.get("no_bias"):
        ins.append(rng.standard_normal(kw["num_filter"]).astype(np.float32))
    assert nd == len(dshape) - 2
    return ins


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_jax(case):
    dshape, kw = DECONV_CASES[case]
    ins = _deconv_inputs(dshape, kw)
    (g_out, _, g_grads), (w_out, _, w_grads) = both("Deconvolution", kw, ins)
    assert_close(g_out, w_out, TOL, case + " outputs")
    assert_close(g_grads, w_grads, TOL, case + " gradients")
    # the port's shape inference is its own output's shape, and the JAX
    # package's where it leaves nothing out (no dilation)
    t_op = treg.get("Deconvolution")
    t_in, t_out, _ = t_op.infer_shape_generic(t_op.parse_params(dict(kw)),
                                              [dshape])
    assert [tuple(s) for s in t_in] == [a.shape for a in ins]
    assert tuple(t_out[0]) == g_out[0].shape
    if not any(d > 1 for d in kw.get("dilate", ())):
        j_op = jreg.get("Deconvolution")
        j_in, j_out, _ = j_op.infer_shape_generic(
            j_op.parse_params(dict(kw)), [dshape])
        assert [tuple(s) for s in j_in] == [tuple(s) for s in t_in]
        assert [tuple(s) for s in j_out] == [tuple(s) for s in t_out]


def test_deconvolution_v1_alias_and_convolution_v1():
    """``Convolution_v1`` is ``Convolution`` in both packages."""
    assert treg.get("Convolution_v1") is treg.get("Convolution")
    rng = np.random.default_rng(3)
    ins = [rng.standard_normal((1, 2, 5, 5)).astype(np.float32),
           rng.standard_normal((3, 2, 3, 3)).astype(np.float32),
           rng.standard_normal(3).astype(np.float32)]
    kw = dict(kernel=(3, 3), num_filter=3, pad=(1, 1))
    (g_out, _, g_grads), (w_out, _, w_grads) = both("Convolution_v1", kw, ins)
    assert_close(g_out + g_grads, w_out + w_grads, TOL, "Convolution_v1")


def test_jax_deconv_infer_shape_leaves_out_dilate():
    """JAX-package defect: ``_deconv_infer_shape`` ignores ``dilate``.
    With kernel 3x3 and dilate 2 on 1x2x4x4 it says 6x6 while the JAX op
    returns 8x8; the port's inference says 8x8, its output's shape."""
    kw = dict(kernel=(3, 3), dilate=(2, 2), num_filter=2, no_bias=True)
    dshape = (1, 2, 4, 4)
    ins = _deconv_inputs(dshape, kw)
    (g_out, _, _), (w_out, _, _) = both("Deconvolution", kw, ins)
    assert w_out[0].shape == g_out[0].shape == (1, 2, 8, 8)
    j_op, t_op = jreg.get("Deconvolution"), treg.get("Deconvolution")
    _, j_out, _ = j_op.infer_shape_generic(j_op.parse_params(dict(kw)),
                                           [dshape])
    _, t_out, _ = t_op.infer_shape_generic(t_op.parse_params(dict(kw)),
                                           [dshape])
    assert tuple(j_out[0]) == (1, 2, 6, 6)
    assert tuple(t_out[0]) == (1, 2, 8, 8)


def test_target_shape_is_ignored_as_in_the_jax_package():
    """JAX-package defect kept: ``target_shape`` is accepted and ignored.
    Kernel 4x4, stride 2, ``target_shape=(9, 9)`` on 4x4 gives 10x10 in
    both packages' inference and both ops."""
    kw = dict(kernel=(4, 4), stride=(2, 2), target_shape=(9, 9),
              num_filter=1, no_bias=True)
    dshape = (1, 1, 4, 4)
    ins = _deconv_inputs(dshape, kw)
    (g_out, _, _), (w_out, _, _) = both("Deconvolution", kw, ins)
    assert g_out[0].shape == w_out[0].shape == (1, 1, 10, 10)
    assert_close(g_out, w_out, TOL, "target_shape")
    for reg in (jreg, treg):
        op = reg.get("Deconvolution")
        _, out, _ = op.infer_shape_generic(op.parse_params(dict(kw)),
                                           [dshape])
        assert tuple(out[0]) == (1, 1, 10, 10)


CROP_CASES = {
    "like_second_input_offset": (
        [(2, 3, 9, 8), (2, 5, 4, 5)], dict(num_args=2, offset=(3, 2))),
    "like_second_input_centre": (
        [(1, 2, 9, 9), (1, 2, 4, 6)], dict(num_args=2, center_crop=True)),
    "h_w_offset": ([(2, 2, 7, 6)], dict(num_args=1, h_w=(3, 4),
                                        offset=(2, 1))),
    "h_w_centre": ([(1, 3, 8, 7)], dict(num_args=1, h_w=(5, 2),
                                        center_crop=True)),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_matches_jax(case):
    shapes, kw = CROP_CASES[case]
    rng = np.random.default_rng(5)
    ins = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    (g_out, _, g_grads), (w_out, _, w_grads) = both("Crop", kw, ins)
    assert_close(g_out, w_out, 0.0, case + " outputs")
    assert_close(g_grads, w_grads, 0.0, case + " gradients")
    for reg in (jreg, treg):
        op = reg.get("Crop")
        _, out, _ = op.infer_shape_generic(op.parse_params(dict(kw)), shapes)
        assert tuple(out[0]) == g_out[0].shape


def test_crop_is_a_view():
    """Crop reads its input in place: no copy on the card's step."""
    import torch
    op = treg.get("Crop")
    p = op.parse_params(dict(num_args=1, h_w=(2, 2), offset=(1, 1)))
    x = torch.arange(32.0).reshape(1, 2, 4, 4)
    (out,), _ = op.apply(p, treg.OpContext(), x)
    assert out.data_ptr() == x[:, :, 1:, 1:].data_ptr()
    assert out.untyped_storage().data_ptr() \
        == x.untyped_storage().data_ptr()
