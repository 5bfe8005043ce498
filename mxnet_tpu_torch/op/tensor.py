"""Shape/layout and indexing ops (``mxnet_tpu/op/tensor.py``).

Reshape and slice_axis return views where torch can: the attention block
slices q, k and v out of one fused projection, and the flash-attention
kernel reads those strided views directly.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import Param, register, alias, get


@register("Reshape", params_spec=(Param("shape", "shape", ()),
                                  Param("reverse", bool, False),
                                  Param("target_shape", "shape", None),
                                  Param("keep_highest", bool, False)),
          hint="reshape")
def _reshape(p, c, a):
    tgt = list(p["shape"] or p["target_shape"] or ())
    if not tgt:
        raise MXNetError("Reshape needs shape")
    src = list(a.shape)
    # reference special codes (matrix_op.cc): 0 copy, -1 infer, -2 copy-rest,
    # -3 merge two, -4 split
    out = []
    i = 0
    j = 0
    while j < len(tgt):
        d = tgt[j]
        if d == 0:
            out.append(src[i]); i += 1
        elif d == -1:
            out.append(-1); i += 1
        elif d == -2:
            out.extend(src[i:]); i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif d == -4:
            d1, d2 = tgt[j + 1], tgt[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2]); i += 1; j += 2
        else:
            out.append(d); i += 1
        j += 1
    if out.count(-1):
        known = math.prod(d for d in out if d != -1) or 1
        out = [math.prod(src) // known if d == -1 else d for d in out]
    return a.reshape(out)


alias("reshape", "Reshape")


@register("slice_axis", params_spec=(
    Param("axis", int, required=True),
    Param("begin", int, required=True),
    Param("end", lambda v: None if v in (None, "None") else int(v), None)))
def _slice_axis(p, c, a):
    ax = p["axis"] % a.ndim
    end = p["end"] if p["end"] is not None else a.shape[ax]
    idx = [slice(None)] * a.ndim
    idx[ax] = slice(p["begin"], end)
    return a[tuple(idx)]


@register("Embedding", params_spec=(Param("input_dim", int, required=True),
                                    Param("output_dim", int, required=True),
                                    Param("dtype", "dtype", torch.float32)),
          input_names=("data", "weight"), hint="embedding")
def _embedding(p, c, data, weight):
    # ids may arrive as floats; an out-of-range id clamps to the table's
    # edge as the JAX package's take(..., mode="clip") does, never raises
    ids = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[ids]


def _embedding_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        return None
    wshape = (p["input_dim"], p["output_dim"])
    return [dshape, wshape], [tuple(dshape) + (p["output_dim"],)], []


def _embedding_infer_dtype(p, in_dtypes):
    # ids and table dtypes are independent: ids default int32, the table
    # the ``dtype`` param, and the gather returns the TABLE dtype
    ddt = in_dtypes[0] if in_dtypes[0] is not None else torch.int32
    wdt = in_dtypes[1] if in_dtypes[1] is not None else p["dtype"]
    return [ddt, wdt], [wdt], []


get("Embedding").infer_shape = _embedding_infer_shape
get("Embedding").infer_dtype = _embedding_infer_dtype
