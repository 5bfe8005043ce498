"""Neural-network layer ops (``mxnet_tpu/op/nn.py``): the forward of the
layers the transformer LM runs.  Matrix products go to ``torch`` (cuBLAS
on the card), as the JAX package leaves them to XLA."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import _softplus
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
@register("Dropout", params_spec=(Param("p", float, 0.5),), hint="dropout")
def _dropout(p, c, a):
    if not c.is_train or p["p"] <= 0.0:
        return a
    raise MXNetError("training-mode Dropout is not ported yet (the port "
                     "runs the eval forward only)")


# ----------------------------------------------------------------------
# SoftmaxOutput: the forward only (its injected gradient comes with the
# training slice)
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
    if p["multi_output"]:
        return torch.softmax(data, dim=1)
    if p["preserve_shape"]:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


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
