"""Neural-network layer ops (``mxnet_tpu/op/nn.py``): the layers the
transformer LM and the convnets (the image-classification zoo) run,
forward and, through torch autograd, backward. Matrix products and
convolutions go to ``torch`` (cuBLAS and cuDNN on the card), as the JAX
package leaves them to XLA; ``SoftmaxOutput`` injects the reference's
gradient through a ``torch.autograd.Function``, and BatchNorm's training
backward is the JAX package's closed form (``op/bytediet.py``)."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import bytediet as _bd
from .elemwise import _softplus
from .tensor import one_hot
from .registry import Param, register, alias, get


# ----------------------------------------------------------------------
# FullyConnected
@register("FullyConnected",
          params_spec=(Param("num_hidden", int, required=True),
                       Param("no_bias", bool, False),
                       Param("flatten", bool, True)),
          input_names=lambda p: ["data", "weight"]
          + ([] if p.get("no_bias") else ["bias"]),
          hint="fullyconnected")
def _fully_connected(p, c, data, weight, bias=None):
    # always flattens to 2-D, whatever ``flatten`` says (as the JAX op
    # does); F.linear returns data's dtype and refuses mixed dtypes
    if data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def _fc_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None or 0 in dshape:
        return None
    in_dim = math.prod(dshape[1:])
    shapes = [tuple(dshape), (p["num_hidden"], in_dim)]
    if not p["no_bias"]:
        shapes.append((p["num_hidden"],))
    return shapes, [(dshape[0], p["num_hidden"])], []


# ----------------------------------------------------------------------
# Convolution
def _conv_spec():
    return (Param("kernel", "shape", required=True),
            Param("stride", "shape", None),
            Param("dilate", "shape", None),
            Param("pad", "shape", None),
            Param("num_filter", int, required=True),
            Param("num_group", int, 1),
            Param("workspace", int, 1024),
            Param("no_bias", bool, False),
            Param("cudnn_tune", str, None),
            Param("cudnn_off", bool, False),
            Param("layout", str, None))


def _conv_tuple(v, nd, default=1):
    if v is None:
        return (default,) * nd
    return tuple(v)


def _channels_last(layout, nd):
    """The reference's ``layout`` param: the NCHW family (also the
    default) or the NHWC family ("NWC", "NHWC", "NDHWC")."""
    if layout is None:
        return False
    layout = layout.upper()
    if layout in ("NCW", "NCHW", "NCDHW"):
        return False
    if layout in ("NWC", "NHWC", "NDHWC"):
        return True
    raise MXNetError("unsupported convolution layout %s" % layout)


def _to_channels_first(a):
    """``(N, *spatial, C)`` as an ``(N, C, *spatial)`` view, no copy (in
    2-D the view is channels-last in memory: cuDNN's NHWC)."""
    return a.permute(0, a.ndim - 1, *range(1, a.ndim - 1))


def _to_channels_last(a):
    return a.permute(0, *range(2, a.ndim), 1)


@contextlib.contextmanager
def _exact_float32(dtype):
    """cuDNN's float32 convolutions in float32, not TF32, inside this
    scope, as the JAX package's float32 means float32 (PyTorch's default
    lets cuDNN round float32 operands to TF32).  The caller's flag comes
    back after it."""
    cudnn = torch.backends.cudnn
    if dtype != torch.float32 or not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


class _ConvolutionFn(torch.autograd.Function):
    """A convolution of ``(N, C, *spatial)`` data with ``(O, C/groups,
    *kernel)`` weights whose forward and backward both run under
    :func:`_exact_float32`: autograd launches the backward's
    convolutions outside the op's body, so the scope goes with them."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, groups):
        geom = (list(stride), list(pad), list(dilate), False,
                [0] * len(stride), groups)
        with _exact_float32(x.dtype):
            out = torch.ops.aten.convolution(x, w, None, *geom)
        ctx.save_for_backward(x, w)
        ctx.geom = geom
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _exact_float32(x.dtype):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, *ctx.geom, mask)
        return gx, gw, None, None, None, None


@register("Convolution", params_spec=_conv_spec(),
          input_names=lambda p: ["data", "weight"]
          + ([] if p.get("no_bias") else ["bias"]),
          hint="convolution")
def _convolution(p, c, data, weight, bias=None):
    """The JAX op's convolution: symmetric ``pad``, ``stride``,
    ``dilate`` and ``num_group``.  Under an NHWC-family layout the data
    is channels-last and the weight ``(*kernel, C/groups, num_filter)``
    (HWIO); under the NCHW family ``(num_filter, C/groups, *kernel)``.
    Channels-last data reaches cuDNN as a view; the HWIO weight is
    permuted to OIHW (cuDNN copies it into the data's memory format).
    ``workspace``, ``cudnn_tune`` and ``cudnn_off`` are accepted and
    ignored, as in the JAX op; the bias is added after, in the data's
    dtype."""
    nd = len(p["kernel"])
    if not 1 <= nd <= 3:
        raise MXNetError("Convolution supports 1-3 spatial dims")
    channels_last = _channels_last(p.get("layout"), nd)
    if channels_last:
        data = _to_channels_first(data)
        weight = weight.permute(nd + 1, nd, *range(nd))
    out = _ConvolutionFn.apply(
        data, weight, _conv_tuple(p["stride"], nd),
        _conv_tuple(p["pad"], nd, 0), _conv_tuple(p["dilate"], nd),
        p["num_group"])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return _to_channels_last(out) if channels_last else out


def _conv_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None or 0 in dshape:
        return None
    nd = len(p["kernel"])
    channels_last = _channels_last(p.get("layout"), nd)
    cin = dshape[-1] if channels_last else dshape[1]
    if channels_last:
        wshape = tuple(p["kernel"]) + (cin // p["num_group"],
                                       p["num_filter"])
        in_sp = dshape[1:-1]
    else:
        wshape = (p["num_filter"], cin // p["num_group"]) + tuple(p["kernel"])
        in_sp = dshape[2:]
    stride = _conv_tuple(p["stride"], nd)
    dilate = _conv_tuple(p["dilate"], nd)
    pad = _conv_tuple(p["pad"], nd, 0)
    out_sp = tuple(
        (in_sp[i] + 2 * pad[i] - (dilate[i] * (p["kernel"][i] - 1) + 1))
        // stride[i] + 1 for i in range(nd))
    shapes = [tuple(dshape), wshape]
    if not p["no_bias"]:
        shapes.append((p["num_filter"],))
    out = (dshape[0],) + out_sp + (p["num_filter"],) if channels_last \
        else (dshape[0], p["num_filter"]) + out_sp
    return shapes, [out], []


# ----------------------------------------------------------------------
# Pooling
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, pool_type, kernel, stride, lo_hi):
    """Pool ``(N, C, *spatial)`` data over windows padded by ``lo_hi``
    per spatial dim.  Where the padding is symmetric and at most half the
    kernel, the library pools with its own padding; otherwise the data is
    padded here (-inf for max, 0 for avg and sum) and pooled without.
    Either way an avg window's divisor is the full kernel size, padding
    included, and a max window that lies wholly in the padding sends its
    cotangent into the padding, which is cut away.  1-D pooling runs as
    2-D over a height of one."""
    nd = len(kernel)
    if nd == 1:
        out = _pool(x.unsqueeze(-2), pool_type, (1,) + kernel,
                    (1,) + stride, ((0, 0),) + lo_hi)
        return out.squeeze(-2)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(lo_hi, kernel)):
        pad = tuple(lo for lo, _ in lo_hi)
    else:
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(x, [q for lo, hi in reversed(lo_hi) for q in (lo, hi)],
                  value=fill)
        pad = (0,) * nd
    if pool_type == "max":
        return _MAX_POOL[nd](x, kernel, stride, pad)
    divisor = 1 if pool_type == "sum" else math.prod(kernel)
    return _AVG_POOL[nd](x, kernel, stride, pad, divisor_override=divisor)


@register("Pooling",
          params_spec=(Param("kernel", "shape", required=True),
                       Param("pool_type", str, "max",
                             enum=("max", "avg", "sum")),
                       Param("global_pool", bool, False),
                       Param("pooling_convention", str, "valid",
                             enum=("valid", "full")),
                       Param("stride", "shape", None),
                       Param("pad", "shape", None),
                       Param("layout", str, None),
                       Param("cudnn_off", bool, False)),
          hint="pooling")
def _pooling(p, c, data):
    """The JAX op's pooling: ``full`` pads the high side by
    ``stride - rem`` (ceil instead of floor), avg divides by the full
    kernel size, padding included, and max keeps the first maximum of
    each window, whose index map is its backward (``op/bytediet.py``)."""
    nd = data.ndim - 2
    channels_last = _channels_last(p.get("layout"), nd)
    x = _to_channels_first(data) if channels_last else data
    spatial = x.shape[2:]
    if p["global_pool"]:
        kernel, stride, pad = tuple(spatial), (1,) * nd, (0,) * nd
    else:
        kernel = tuple(p["kernel"])
        stride = _conv_tuple(p["stride"], nd)
        pad = _conv_tuple(p["pad"], nd, 0)
    lo_hi = []
    for i in range(nd):
        hi = pad[i]
        if p["pooling_convention"] == "full" and not p["global_pool"]:
            rem = (spatial[i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem != 0:
                hi += stride[i] - rem      # ceil instead of floor
        lo_hi.append((pad[i], hi))
    out = _pool(x, p["pool_type"], kernel, stride, tuple(lo_hi))
    return _to_channels_last(out) if channels_last else out


alias("Pooling_v1", "Pooling")


def _pool_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None or 0 in dshape:
        return None
    nd = len(dshape) - 2
    channels_last = _channels_last(p.get("layout"), nd)

    def assemble(sp):
        if channels_last:
            return (dshape[0],) + tuple(sp) + (dshape[-1],)
        return tuple(dshape[:2]) + tuple(sp)

    spatial = dshape[1:-1] if channels_last else dshape[2:]
    if p["global_pool"]:
        return [tuple(dshape)], [assemble((1,) * nd)], []
    kernel = tuple(p["kernel"])
    stride = _conv_tuple(p["stride"], nd)
    pad = _conv_tuple(p["pad"], nd, 0)
    out_sp = []
    for i in range(nd):
        size = spatial[i] + 2 * pad[i] - kernel[i]
        if p["pooling_convention"] == "full":
            out_sp.append(-(-size // stride[i]) + 1)
        else:
            out_sp.append(size // stride[i] + 1)
    return [tuple(dshape)], [assemble(out_sp)], []


# ----------------------------------------------------------------------
# Activations
_ACT = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": _softplus,     # jax.nn.softplus: no threshold
    # jax.nn.gelu's default is the tanh approximation (GPT-2's gelu_new)
    "gelu": lambda a: F.gelu(a, approximate="tanh"),
}


@register("Activation",
          params_spec=(Param("act_type", str, required=True,
                             enum=tuple(_ACT)),),
          hint="activation")
def _activation(p, c, a):
    return _ACT[p["act_type"]](a)


@register("LayerNorm",
          params_spec=(Param("axis", int, -1),
                       Param("eps", float, 1e-5)),
          input_names=("data", "gamma", "beta"),
          hint="layernorm")
def _layer_norm(p, c, data, gamma, beta):
    """Layer normalization over one axis: population variance,
    ``rsqrt(var + eps)``, then the learned scale and shift."""
    ax = p["axis"]
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, unbiased=False, keepdim=True)
    normed = (data - mean) * torch.rsqrt(var + p["eps"])
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    return normed * gamma.reshape(shape) + beta.reshape(shape)


def _ln_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None or 0 in dshape:
        return None
    n = dshape[p["axis"]]
    return [tuple(dshape), (n,), (n,)], [tuple(dshape)], []


# ----------------------------------------------------------------------
# LRN
@register("LRN", params_spec=(Param("alpha", float, 1e-4),
                              Param("beta", float, 0.75),
                              Param("knorm", float, 2.0),
                              Param("nsize", int, required=True)),
          hint="lrn")
def _lrn(p, c, a):
    """Local response normalisation across channels (axis 1), the JAX
    op's formula: the squares padded by ``nsize // 2`` zeros on both
    sides of the channel axis, a window of ``nsize`` shifted slices of
    ``C`` channels summed (for an even ``nsize`` too), then
    ``a / (knorm + alpha / nsize * sum) ** beta``.  Autograd gives the
    backward."""
    nsize = p["nsize"]
    half = nsize // 2
    C = a.shape[1]
    sq = a * a
    sq_pad = F.pad(sq, [0, 0] * (a.ndim - 2) + [half, half])
    window = sq_pad[:, 0:C]
    for i in range(1, nsize):
        window = window + sq_pad[:, i:i + C]
    scale = p["knorm"] + (p["alpha"] / nsize) * window
    return a / scale.pow(p["beta"])


# ----------------------------------------------------------------------
# Dropout
@register("Dropout", params_spec=(Param("p", float, 0.5),), uses_rng=True,
          mode_dependent=True, hint="dropout")
def _dropout(p, c, a):
    """Inverted dropout: in training each element is kept with
    probability ``1 - p`` and divided by ``1 - p`` (rounded to the
    input's dtype, as the JAX package's weakly typed ``a / keep``), the
    mask drawn from the OpContext's generator; the identity otherwise."""
    if not c.is_train or p["p"] <= 0.0:
        return a
    keep = 1.0 - p["p"]
    mask = torch.empty(a.shape, dtype=torch.float32, device=a.device) \
        .bernoulli_(keep, generator=c.rng)
    # a true division by a 0-d tensor on a's device (CUDA divides by a
    # host scalar as a product with its reciprocal), made by a fill, so
    # a captured CUDA graph copies nothing from the host
    keep = torch.full((), keep, dtype=a.dtype, device=a.device)
    return torch.where(mask != 0, a / keep, 0.0)


# ----------------------------------------------------------------------
# BatchNorm
def _scalar(v, like):
    """A Python number in ``like``'s dtype, on its device: the JAX
    package's weakly typed scalars round to the array's dtype before the
    arithmetic (PyTorch would keep a float32 scalar beside a bfloat16
    tensor).  Made by a fill, so a captured CUDA graph copies nothing
    from the host."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


@register("BatchNorm",
          params_spec=(Param("eps", float, 1e-3),
                       Param("momentum", float, 0.9),
                       Param("fix_gamma", bool, True),
                       Param("use_global_stats", bool, False),
                       Param("output_mean_var", bool, False),
                       Param("axis", int, 1),
                       Param("cudnn_off", bool, False)),
          input_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"),
          num_outputs=lambda p: 3 if p.get("output_mean_var") else 1,
          output_names=lambda p: (["output", "mean", "var"]
                                  if p.get("output_mean_var") else ["output"]),
          mode_dependent=True, hint="batchnorm")
def _batch_norm(p, c, data, gamma, beta, moving_mean, moving_var):
    """Batch normalization over every axis but ``axis``.  In training
    (unless ``use_global_stats``) the statistics are the batch's, float32
    and single-pass (``op/bytediet.py``), cast to the data's dtype, and
    the moving averages become ``m * old + (1 - m) * batch`` in the aux
    states' dtype; the normalize's backward is the closed form, or under
    the ``legacy`` policy or with ``output_mean_var`` autograd through
    ``(x - mean) * rsqrt(var + eps) * gamma + beta``, which is also the
    inference path, on the moving statistics.  ``fix_gamma`` holds gamma
    at one, with no gradient."""
    ax = p["axis"] % data.ndim
    reduce_axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    if p["fix_gamma"]:
        gamma = torch.ones_like(gamma)
    if c.is_train and not p["use_global_stats"]:
        closed = _bd.enabled(c) and not p["output_mean_var"]
        # the closed form differentiates the statistics itself
        with torch.set_grad_enabled(torch.is_grad_enabled() and not closed):
            mean32, var32 = _bd.bn_batch_stats(data, moving_mean.float(),
                                               reduce_axes)
        mean, var = mean32.to(data.dtype), var32.to(data.dtype)
        m = p["momentum"]
        new_mean = moving_mean * _scalar(m, moving_mean) \
            + mean.detach() * _scalar(1 - m, mean)
        new_var = moving_var * _scalar(m, moving_var) \
            + var.detach() * _scalar(1 - m, var)
        if closed:
            out = _bd.bn_train_normalize(data, gamma, beta, mean32, var32,
                                         ax, p["eps"])
            return out, new_mean, new_var
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + _scalar(p["eps"], var))
    out = (data - mean.reshape(bshape)) * inv.reshape(bshape) \
        * gamma.reshape(bshape) + beta.reshape(bshape)
    if p["output_mean_var"]:
        return out, mean, var, new_mean, new_var
    return out, new_mean, new_var


def _bn_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        return None
    ch = (dshape[p["axis"]],)
    outs = [tuple(dshape), ch, ch] if p["output_mean_var"] \
        else [tuple(dshape)]
    return [tuple(dshape), ch, ch], outs, [ch, ch]


# ----------------------------------------------------------------------
# SoftmaxOutput: the softmax forward, and the reference's injected
# gradient in place of the softmax's own
def _softmax_forward(p, data):
    if p["multi_output"]:
        return torch.softmax(data, dim=1)
    if p["preserve_shape"]:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


class _SoftmaxOutputFn(torch.autograd.Function):
    """``SoftmaxOutput`` with its injected gradient: the port of
    ``mxnet_tpu/op/nn.py:_softmax_output_bwd``.  The data's gradient is
    ``(softmax - one_hot(label))`` (or ``- label`` for a dense label),
    ignored labels zeroed, divided per ``normalization``, times the head
    gradient only with ``out_grad``, times ``grad_scale``; the label's
    gradient is none."""

    @staticmethod
    def forward(ctx, data, label, p):
        out = _softmax_forward(p, data)
        ctx.save_for_backward(out, label)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        p = ctx.p
        ignore = p["use_ignore"]
        if p["multi_output"]:
            # data (n, c, ...), label (n, ...): one-hot over axis 1
            oh = one_hot(label, out.shape[1], out.dtype).movedim(-1, 1)
            grad = out - oh
            valid = torch.ones(label.shape, dtype=out.dtype, device=out.device)
            if ignore:
                valid = (label != p["ignore_label"]).to(out.dtype)
                grad = grad * valid.unsqueeze(1)
        elif label.dim() == out.dim():
            grad = out - label.to(out.dtype)      # dense label
            valid = torch.ones(label.shape[:1], dtype=out.dtype,
                               device=out.device)
        else:
            oh = one_hot(label, out.shape[-1], out.dtype)
            grad = out - oh.reshape(out.shape)
            valid = torch.ones(label.shape, dtype=out.dtype, device=out.device)
            if ignore:
                valid = (label != p["ignore_label"]).to(out.dtype)
                grad = grad * valid.reshape(
                    label.shape + (1,) * (out.dim() - label.dim()))
        if p["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif p["normalization"] == "valid":
            grad = grad / valid.sum().clamp(min=1.0)
        if p["out_grad"]:
            grad = grad * g
        return grad * p["grad_scale"], None, None


@register("SoftmaxOutput",
          params_spec=(Param("grad_scale", float, 1.0),
                       Param("ignore_label", float, -1.0),
                       Param("multi_output", bool, False),
                       Param("use_ignore", bool, False),
                       Param("preserve_shape", bool, False),
                       Param("normalization", str, "null",
                             enum=("null", "batch", "valid")),
                       Param("out_grad", bool, False)),
          input_names=("data", "label"), hint="softmaxoutput")
def _softmax_output(p, c, data, label):
    if torch.is_grad_enabled() and data.requires_grad:
        return _SoftmaxOutputFn.apply(data, label, p)
    return _softmax_forward(p, data)


alias("Softmax", "SoftmaxOutput")


def _softmax_out_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        return None
    if p.get("multi_output"):
        lshape = (dshape[0],) + tuple(dshape[2:])
    else:
        lshape = (dshape[0],)
    if in_shapes[1] is not None and tuple(in_shapes[1]) != lshape \
            and 0 not in in_shapes[1]:
        lshape = tuple(in_shapes[1])  # dense labels allowed
    return [tuple(dshape), lshape], [tuple(dshape)], []


get("LayerNorm").infer_shape = _ln_infer_shape
get("FullyConnected").infer_shape = _fc_infer_shape
get("SoftmaxOutput").infer_shape = _softmax_out_infer_shape
get("Convolution").infer_shape = _conv_infer_shape
get("Pooling").infer_shape = _pool_infer_shape
get("BatchNorm").infer_shape = _bn_infer_shape
