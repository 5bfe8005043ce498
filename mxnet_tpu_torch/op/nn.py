"""Neural-network layer ops (``mxnet_tpu/op/nn.py``), forward and,
through torch autograd, backward. Matrix products and (transposed)
convolutions go to ``torch`` (cuBLAS and cuDNN on the card), as the JAX
package leaves them to XLA; the loss layers (``SoftmaxOutput``, the
regression outputs, ``SVMOutput``, ``MakeLoss``) inject the JAX
package's gradients through ``torch.autograd.Function``s, and
BatchNorm's training backward is the JAX package's closed form
(``op/bytediet.py``)."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import bytediet as _bd
from .elemwise import _softplus
from .tensor import one_hot, _in_range
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
    """A convolution of ``(N, C, *spatial)`` data, or with ``transposed``
    its transpose (``Deconvolution``; weights ``(C, O/groups, *kernel)``,
    ``out_pad`` extra positions at the far edge), whose forward and
    backward both run under :func:`_exact_float32`: autograd launches
    the backward's convolutions outside the op's body, so the scope goes
    with them."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, groups, transposed=False,
                out_pad=None):
        geom = (list(stride), list(pad), list(dilate), transposed,
                list(out_pad or [0] * len(stride)), groups)
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
        return gx, gw, None, None, None, None, None, None


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


def _deconv_geometry(p, nd):
    """``(stride, dilate, pad, adj)`` of a Deconvolution; its output
    extent a spatial dim is ``stride * (in - 1) + dilate * (kernel - 1)
    + 1 - 2 * pad + adj``, as the JAX op's body computes it (dilation
    included)."""
    return (_conv_tuple(p["stride"], nd), _conv_tuple(p["dilate"], nd),
            _conv_tuple(p["pad"], nd, 0), _conv_tuple(p["adj"], nd, 0))


@register("Deconvolution",
          params_spec=_conv_spec() + (Param("adj", "shape", None),
                                      Param("target_shape", "shape", None)),
          input_names=lambda p: ["data", "weight"]
          + ([] if p.get("no_bias") else ["bias"]),
          hint="deconvolution")
def _deconvolution(p, c, data, weight, bias=None):
    """The JAX op's transposed convolution: weights ``(C, num_filter /
    num_group, *kernel)`` under every layout (an NHWC-family layout
    moves only the data), ``stride``, ``dilate``, symmetric ``pad``,
    ``num_group``, and ``adj`` extra positions at the far edge of each
    spatial dim.  cuDNN's transposed convolution takes ``adj`` as its
    ``output_padding`` where it accepts it (below both ``stride`` and
    ``dilate``); a larger ``adj`` is the full transposed convolution,
    unpadded, cut to the output's window and padded with zeros past its
    end, which is what the JAX op's padding gives.  ``target_shape`` is
    accepted and ignored, as the JAX op ignores it."""
    nd = len(p["kernel"])
    if not 1 <= nd <= 3:
        raise MXNetError("Deconvolution supports 1-3 spatial dims")
    channels_last = _channels_last(p.get("layout"), nd)
    if channels_last:
        data = _to_channels_first(data)
    stride, dilate, pad, adj = _deconv_geometry(p, nd)
    g = p["num_group"]
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        out = _ConvolutionFn.apply(data, weight, stride, pad, dilate, g,
                                   True, adj)
    else:
        full = _ConvolutionFn.apply(data, weight, stride, (0,) * nd,
                                    dilate, g, True, (0,) * nd)
        window = []
        tail = []
        for i in range(nd):
            size = full.shape[2 + i] - 2 * pad[i] + adj[i]
            stop = min(pad[i] + size, full.shape[2 + i])
            window.append(slice(pad[i], stop))
            tail.append(pad[i] + size - stop)
        out = full[(slice(None), slice(None)) + tuple(window)]
        if any(tail):
            out = F.pad(out, [q for t in reversed(tail) for q in (0, t)])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return _to_channels_last(out) if channels_last else out


def _deconv_infer_shape(p, in_shapes):
    """The body's output extent, dilation included (the JAX package's
    ``_deconv_infer_shape`` leaves ``dilate`` out, so it disagrees with
    its own op's output when ``dilate > 1``); ``target_shape`` is
    ignored, as in both JAX functions."""
    dshape = in_shapes[0]
    if dshape is None or 0 in dshape:
        return None
    nd = len(p["kernel"])
    channels_last = _channels_last(p.get("layout"), nd)
    stride, dilate, pad, adj = _deconv_geometry(p, nd)
    cin = dshape[-1] if channels_last else dshape[1]
    in_sp = dshape[1:-1] if channels_last else dshape[2:]
    wshape = (cin, p["num_filter"] // p["num_group"]) + tuple(p["kernel"])
    out_sp = tuple(stride[i] * (in_sp[i] - 1)
                   + dilate[i] * (p["kernel"][i] - 1) + 1 - 2 * pad[i]
                   + adj[i] for i in range(nd))
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
    states' dtype (over a data mesh, the whole batch's: ``OpContext``
    ``batch_sum``); the normalize's backward is the closed form, or under
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
                                               reduce_axes, c.batch_sum,
                                               c.batch_ranks)
        mean, var = mean32.to(data.dtype), var32.to(data.dtype)
        m = p["momentum"]
        new_mean = moving_mean * _scalar(m, moving_mean) \
            + mean.detach() * _scalar(1 - m, mean)
        new_var = moving_var * _scalar(m, moving_var) \
            + var.detach() * _scalar(1 - m, var)
        if closed:
            out = _bd.bn_train_normalize(data, gamma, beta, mean32, var32,
                                         ax, p["eps"], c.batch_sum,
                                         c.batch_ranks)
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


# ----------------------------------------------------------------------
# LeakyReLU, the softmaxes, InstanceNorm, L2Normalization
@register("LeakyReLU",
          params_spec=(Param("act_type", str, "leaky",
                             enum=("rrelu", "leaky", "prelu", "elu")),
                       Param("slope", float, 0.25),
                       Param("lower_bound", float, 0.125),
                       Param("upper_bound", float, 0.334)),
          input_names=lambda p: ["data", "gamma"]
          if p.get("act_type") == "prelu" else ["data"],
          uses_rng=True, rng_in_eval=False, mode_dependent=True,
          hint="leakyrelu")
def _leaky_relu(p, c, data, gamma=None):
    """``slope * x`` (leaky), ``slope * expm1(x)`` (elu) or ``gamma * x``
    with one gamma a channel (prelu) below zero; rrelu's slope is drawn
    uniformly from ``[lower_bound, upper_bound)`` an element in training
    (from the OpContext's generator) and is the bounds' mean otherwise."""
    t = p["act_type"]
    if t == "leaky":
        neg = p["slope"] * data
    elif t == "elu":
        neg = p["slope"] * torch.expm1(data)
    elif t == "prelu":
        neg = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) * data
    elif c.is_train:
        slope = torch.empty(data.shape, dtype=data.dtype,
                            device=data.device).uniform_(
            p["lower_bound"], p["upper_bound"], generator=c.rng)
        neg = slope * data
    else:
        neg = (p["lower_bound"] + p["upper_bound"]) / 2.0 * data
    return torch.where(data > 0, data, neg)


def _prelu_infer_shape(p, in_shapes):
    if p["act_type"] != "prelu" or in_shapes[0] is None:
        return None
    dshape = tuple(in_shapes[0])
    return [dshape, (dshape[1],)], [dshape], []


@register("SoftmaxActivation",
          params_spec=(Param("mode", str, "instance",
                             enum=("instance", "channel")),),
          hint="softmaxactivation")
def _softmax_activation(p, c, a):
    if p["mode"] == "channel":
        return torch.softmax(a, dim=1)
    return torch.softmax(a.reshape(a.shape[0], -1), dim=-1).reshape(a.shape)


def _tempered(p, a):
    """``a / temperature`` (a true division, by a fill on a's device),
    or ``a`` where no temperature (or 0) is given."""
    t = p["temperature"]
    return a / _scalar(t, a) if t else a


@register("softmax", params_spec=(Param("axis", int, -1),
                                  Param("temperature", float, None)))
def _softmax(p, c, a):
    return torch.softmax(_tempered(p, a), dim=p["axis"])


@register("log_softmax", params_spec=(Param("axis", int, -1),
                                      Param("temperature", float, None)))
def _log_softmax(p, c, a):
    return torch.log_softmax(_tempered(p, a), dim=p["axis"])


@register("InstanceNorm", params_spec=(Param("eps", float, 1e-3),),
          input_names=("data", "gamma", "beta"), hint="instancenorm")
def _instance_norm(p, c, data, gamma, beta):
    """Normalization over the spatial axes of each instance and channel
    (population variance), then a scale and shift a channel."""
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + p["eps"]) \
        * gamma.reshape(bshape) + beta.reshape(bshape)


def _in_infer_shape(p, in_shapes):
    if in_shapes[0] is None:
        return None
    dshape = tuple(in_shapes[0])
    ch = (dshape[1],)
    return [dshape, ch, ch], [dshape], []


@register("L2Normalization",
          params_spec=(Param("eps", float, 1e-10),
                       Param("mode", str, "instance",
                             enum=("instance", "channel", "spatial"))),
          hint="l2normalization")
def _l2_normalization(p, c, a):
    """``a / sqrt(sum(a^2) + eps)`` over every axis but the first
    (instance), the channel axis (channel) or the spatial axes
    (spatial)."""
    if p["mode"] == "instance":
        axes = tuple(range(1, a.ndim))
    elif p["mode"] == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, a.ndim))
    return a / torch.sqrt((a * a).sum(dim=axes, keepdim=True) + p["eps"])


# ----------------------------------------------------------------------
# The other loss layers: each injects the JAX package's gradient through
# a torch.autograd.Function, as SoftmaxOutput does, and ignores the head
# gradient where the JAX op does; a label gets no gradient
def _label_infer_shape(p, in_shapes):
    """A regression output's shapes: the label is the data's shape, or
    ``(N,)`` for data ``(N, 1)``, unless it is known already."""
    dshape = in_shapes[0]
    if dshape is None:
        return None
    lshape = in_shapes[1]
    if lshape is None or 0 in lshape:
        lshape = (dshape[0],) if len(dshape) == 2 and dshape[1] == 1 \
            else dshape
    return [tuple(dshape), tuple(lshape)], [tuple(dshape)], []


class _RegressionFn(torch.autograd.Function):
    """``forward(data)`` and the gradient ``grad(out, label) *
    grad_scale / num_output``, ``num_output`` the label's elements a
    row (``mxnet_tpu/op/nn.py`` ``_make_regression``)."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = math.prod(label.shape[1:]) if label.ndim > 1 else 1
        grad = ctx.grad(out, label.reshape(out.shape)) \
            * (ctx.grad_scale / num_output)
        return grad, None, None, None, None


def _make_regression(name, fwd, grad):
    def body(p, c, data, label):
        if torch.is_grad_enabled() and data.requires_grad:
            return _RegressionFn.apply(data, label, fwd, grad,
                                       p["grad_scale"])
        return fwd(data)

    register(name, body, params_spec=(Param("grad_scale", float, 1.0),),
             input_names=("data", "label"), hint=name.lower())
    get(name).infer_shape = _label_infer_shape


_make_regression("LinearRegressionOutput", lambda d: d, lambda o, l: o - l)
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda o, l: o - l)
_make_regression("MAERegressionOutput", lambda d: d,
                 lambda o, l: torch.sign(o - l))


class _SVMOutputFn(torch.autograd.Function):
    """The identity forward and the JAX op's hinge gradient
    (``_svm_bwd``): with ``s = 2 * one_hot(label) - 1`` and ``dist =
    margin - s * data``, ``-s * coef`` where ``dist > 0`` (L1, with
    ``use_linear``) or ``-2 * s * dist * coef`` (L2); the head gradient
    is ignored."""

    @staticmethod
    def forward(ctx, data, label, p):
        ctx.save_for_backward(data, label)
        ctx.p = p
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        p = ctx.p
        sign = 2 * one_hot(label, data.shape[1], data.dtype) - 1
        dist = p["margin"] - sign * data
        if p["use_linear"]:
            grad = torch.where(dist > 0, -sign, 0.0)
        else:
            grad = torch.where(dist > 0, -2 * sign * dist, 0.0)
        return (grad * p["regularization_coefficient"]).to(data.dtype), \
            None, None


@register("SVMOutput",
          params_spec=(Param("margin", float, 1.0),
                       Param("regularization_coefficient", float, 1.0),
                       Param("use_linear", bool, False)),
          input_names=("data", "label"), hint="svmoutput")
def _svm_output(p, c, data, label):
    if torch.is_grad_enabled() and data.requires_grad:
        return _SVMOutputFn.apply(data, label, p)
    return data


class _MakeLossFn(torch.autograd.Function):
    """The identity forward and the gradient ``grad_scale`` everywhere,
    divided by the batch under ``normalization="batch"``; ``"valid"``
    is ``"null"`` and ``valid_thresh`` is never read, as in the JAX op;
    the head gradient is ignored."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization):
        ctx.shape, ctx.dtype = data.shape, data.dtype
        ctx.grad_scale, ctx.normalization = grad_scale, normalization
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        grad = torch.full(ctx.shape, ctx.grad_scale, dtype=ctx.dtype,
                          device=g.device)
        if ctx.normalization == "batch":
            grad = grad / ctx.shape[0]
        return grad, None, None


@register("MakeLoss",
          params_spec=(Param("grad_scale", float, 1.0),
                       Param("valid_thresh", float, 0.0),
                       Param("normalization", str, "null",
                             enum=("null", "batch", "valid"))),
          hint="makeloss")
def _make_loss(p, c, data):
    if torch.is_grad_enabled() and data.requires_grad:
        return _MakeLossFn.apply(data, p["grad_scale"], p["normalization"])
    return data


@register("softmax_cross_entropy", input_names=("data", "label"))
def _softmax_cross_entropy(p, c, data, label):
    """``-sum(log_softmax(data)[i, label[i]])`` as shape ``(1,)``."""
    logp = torch.log_softmax(data, dim=-1)
    picked = logp.gather(-1, label.to(torch.int64).reshape(-1, 1))
    return -picked.sum().reshape((1,))


@register("IdentityAttachKLSparseReg",
          params_spec=(Param("sparseness_target", float, 0.1),
                       Param("penalty", float, 0.001),
                       Param("momentum", float, 0.9)),
          aux_names=("moving_avg",), hint="identityattachklsparsereg")
def _identity_kl_sparse(p, c, data, moving_avg):
    """The identity forward; the gradient adds, to every element, the
    head gradient's sum times the derivative of the KL penalty
    ``penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))`` through
    ``rho_hat = mean(sigmoid(data))``; ``moving_avg`` moves toward
    ``rho_hat`` by ``momentum``, on the device."""
    rho_hat = torch.sigmoid(data).mean()
    rho = p["sparseness_target"]
    penalty = p["penalty"] * (-rho / (rho_hat + 1e-8)
                              + (1 - rho) / (1 - rho_hat + 1e-8))
    out = data + (penalty - penalty.detach())
    m = p["momentum"]
    new_avg = moving_avg * m + rho_hat.detach() * (1 - m)
    return out, new_avg


def _kl_sparse_infer_shape(p, in_shapes):
    if in_shapes[0] is None:
        return None
    return [tuple(in_shapes[0])], [tuple(in_shapes[0])], [(1,)]


# ----------------------------------------------------------------------
# Sequence ops over (T, N, ...): the time axis is 0 whatever ``axis``
# says, as in the JAX ops
def _seq_spec():
    return (Param("use_sequence_length", bool, False),
            Param("axis", int, 0))


def _seq_inputs(p):
    return ["data"] + (["sequence_length"]
                       if p.get("use_sequence_length") else [])


@register("SequenceLast", params_spec=_seq_spec(), input_names=_seq_inputs,
          hint="sequencelast")
def _sequence_last(p, c, data, sequence_length=None):
    if sequence_length is None:
        return data[-1]
    idx = _in_range(sequence_length.detach() - 1, data.shape[0])
    return data[idx, torch.arange(data.shape[1], device=data.device)]


@register("SequenceMask",
          params_spec=_seq_spec() + (Param("value", float, 0.0),),
          input_names=_seq_inputs, hint="sequencemask")
def _sequence_mask(p, c, data, sequence_length=None):
    if sequence_length is None:
        return data
    T = data.shape[0]
    steps = torch.arange(T, device=data.device).reshape(
        (T, 1) + (1,) * (data.ndim - 2))
    lens = sequence_length.detach().reshape((1, -1) + (1,) * (data.ndim - 2))
    return torch.where(steps < lens, data, _scalar(p["value"], data))


@register("SequenceReverse", params_spec=_seq_spec(),
          input_names=_seq_inputs, hint="sequencereverse")
def _sequence_reverse(p, c, data, sequence_length=None):
    """The first ``length`` steps of each sequence reversed, the rest in
    place (all steps without ``sequence_length``)."""
    if sequence_length is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    t = torch.arange(T, device=data.device).unsqueeze(1)
    ln = sequence_length.detach().to(torch.int64).unsqueeze(0)
    idx = _in_range(torch.where(t < ln, ln - 1 - t, t), T)
    return data[idx, torch.arange(data.shape[1], device=data.device)]


# ----------------------------------------------------------------------
# UpSampling
@register("UpSampling",
          params_spec=(Param("scale", int, required=True),
                       Param("num_filter", int, 0),
                       Param("sample_type", str, "nearest",
                             enum=("nearest", "bilinear")),
                       Param("multi_input_mode", str, "concat",
                             enum=("concat", "sum")),
                       Param("num_args", int, 1),
                       Param("workspace", int, 512)),
          input_names=lambda p: ["arg%d" % i for i in range(p["num_args"])],
          hint="upsampling")
def _upsampling(p, c, *xs):
    """Each ``(N, C, H, W)`` input scaled by ``scale``: nearest repeats
    pixels; bilinear is ``jax.image.resize(..., "bilinear")``, half-pixel
    centres with the taps outside the image dropped and the rest
    renormalised, which for an upscale is ``F.interpolate``'s bilinear
    without ``align_corners`` (its edge clamp gives the same values).
    Later inputs are cut to the first's size, then summed or
    concatenated along channels."""
    s = p["scale"]
    outs = []
    for x in xs:
        if p["sample_type"] == "nearest":
            up = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        else:
            up = F.interpolate(x, scale_factor=s, mode="bilinear",
                               align_corners=False)
        if outs and up.shape[2:] != outs[0].shape[2:]:
            up = up[:, :, :outs[0].shape[2], :outs[0].shape[3]]
        outs.append(up)
    if len(outs) == 1:
        return outs[0]
    if p["multi_input_mode"] == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


get("LayerNorm").infer_shape = _ln_infer_shape
get("FullyConnected").infer_shape = _fc_infer_shape
get("SoftmaxOutput").infer_shape = _softmax_out_infer_shape
get("Convolution").infer_shape = _conv_infer_shape
alias("Convolution_v1", "Convolution")
get("Deconvolution").infer_shape = _deconv_infer_shape
get("Pooling").infer_shape = _pool_infer_shape
get("BatchNorm").infer_shape = _bn_infer_shape
get("LeakyReLU").infer_shape = _prelu_infer_shape
get("InstanceNorm").infer_shape = _in_infer_shape
get("SVMOutput").infer_shape = _softmax_out_infer_shape
get("IdentityAttachKLSparseReg").infer_shape = _kl_sparse_infer_shape
