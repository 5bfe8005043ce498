"""Neural-network layer ops (``mxnet_tpu/op/nn.py``): the layers the
transformer LM runs, forward and, through torch autograd, backward.
Matrix products go to ``torch`` (cuBLAS on the card), as the JAX package
leaves them to XLA; ``SoftmaxOutput`` injects the reference's gradient
through a ``torch.autograd.Function``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
