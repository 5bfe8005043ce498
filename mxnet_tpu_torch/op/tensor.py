"""Shape/layout, linear algebra, reduction and indexing ops
(``mxnet_tpu/op/tensor.py``).

Reshape and slice_axis return views where torch can: the attention block
slices q, k and v out of one fused projection, and the flash-attention
kernel reads those strided views directly.
"""
from __future__ import annotations

import ast
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, cast
from .registry import Param, register, alias, get


def _axis_param(name="axis", default=None, required=False):
    def parse(v):
        if v is None or v == "None" or v == "()":
            return None
        if isinstance(v, str):
            v = ast.literal_eval(v)
        if isinstance(v, (list, tuple)):
            return tuple(int(x) for x in v)
        return int(v)
    return Param(name, parse, default, required=required)


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


@register("Flatten", hint="flatten")
def _flatten(p, c, a):
    return a.reshape((a.shape[0], -1))


alias("flatten", "Flatten")


@register("transpose", params_spec=(_axis_param("axes", None),))
def _transpose(p, c, a):
    axes = p["axes"]
    if isinstance(axes, int):
        axes = (axes,)
    return a.permute(axes if axes else tuple(reversed(range(a.ndim))))


@register("expand_dims", params_spec=(Param("axis", int, required=True),))
def _expand_dims(p, c, a):
    return a.unsqueeze(p["axis"])


@register("Concat", params_spec=(Param("num_args", int, required=True),
                                 Param("dim", int, 1)),
          input_names=lambda p: ["arg%d" % i for i in range(p["num_args"])],
          hint="concat")
def _concat(p, c, *xs):
    return torch.cat(xs, dim=p["dim"])


alias("concat", "Concat")


@register("SliceChannel", params_spec=(Param("num_outputs", int,
                                             required=True),
                                       Param("axis", int, 1),
                                       Param("squeeze_axis", bool, False)),
          num_outputs=lambda p: p["num_outputs"], hint="slicechannel")
def _slice_channel(p, c, a):
    """``num_outputs`` equal views along ``axis`` (``jnp.split``: the
    axis must divide evenly); ``squeeze_axis`` drops the axis from each."""
    n, ax = p["num_outputs"], p["axis"] % a.ndim
    if a.shape[ax] % n:
        raise MXNetError("SliceChannel: axis %d of length %d does not split "
                         "into %d equal parts" % (ax, a.shape[ax], n))
    parts = a.split(a.shape[ax] // n, dim=ax)
    if p["squeeze_axis"]:
        parts = [x.squeeze(ax) for x in parts]
    return tuple(parts)


alias("split", "SliceChannel")


@register("Cast", params_spec=(Param("dtype", "dtype", required=True),),
          hint="cast")
def _cast(p, c, a):
    return cast(a, p["dtype"])


alias("cast", "Cast")


@register("broadcast_to", params_spec=(Param("shape", "shape",
                                             required=True),))
def _broadcast_to(p, c, a):
    return a.expand([s if s != 0 else a.shape[i]
                     for i, s in enumerate(p["shape"])])


# ----------------------------------------------------------------------
# linear algebra: bfloat16 and float16 products accumulate and return in
# float32, as the JAX op asks XLA for (``preferred_element_type``)
_ACC = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


@register("dot", params_spec=(Param("transpose_a", bool, False),
                              Param("transpose_b", bool, False)),
          input_names=("lhs", "rhs"))
def _dot(p, c, a, b):
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape((1,))
    if p["transpose_a"]:
        a = a.T
    if p["transpose_b"]:
        b = b.T
    acc = _ACC.get(a.dtype)
    if acc is not None:
        a, b = a.to(acc), b.to(acc)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", params_spec=(Param("transpose_a", bool, False),
                                    Param("transpose_b", bool, False)),
          input_names=("lhs", "rhs"))
def _batch_dot(p, c, a, b):
    if p["transpose_a"]:
        a = a.transpose(-1, -2)
    if p["transpose_b"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


# ----------------------------------------------------------------------
# reductions: jax.numpy keeps an int array's dtype through sum and prod
# (torch widens to int64) and gives float32 for an int mean
def _prod(a, dims, keepdim):
    for d in sorted(dims, reverse=True):
        a = torch.prod(a, dim=d, keepdim=keepdim)
    return a


def _mean(a, dims, keepdim):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return torch.mean(a, dim=dims, keepdim=keepdim)


_REDUCERS = {
    "sum": lambda a, d, k: torch.sum(a, dim=d, keepdim=k),
    "mean": _mean,
    "max": lambda a, d, k: torch.amax(a, dim=d, keepdim=k),
    "min": lambda a, d, k: torch.amin(a, dim=d, keepdim=k),
    "prod": _prod,
    "nansum": lambda a, d, k: torch.nansum(a, dim=d, keepdim=k),
    "nanprod": lambda a, d, k: _prod(
        torch.where(torch.isnan(a), torch.ones_like(a), a), d, k),
}


def _reduce(fn, p, a):
    ax = p["axis"]
    dims = tuple(range(a.ndim)) if ax is None \
        else (ax,) if isinstance(ax, int) else ax
    dims = tuple(d % a.ndim for d in dims)
    out = fn(a, dims, p["keepdims"])
    if not a.is_floating_point() and not out.is_floating_point():
        out = out.to(a.dtype)
    if ax is None and not p["keepdims"]:
        out = out.reshape((1,))  # reference: full reduce -> shape (1,)
    return out


for _name, _fn in _REDUCERS.items():
    register(_name,
             lambda p, c, a, _fn=_fn: _reduce(_fn, p, a),
             params_spec=(_axis_param(), Param("keepdims", bool, False)))

alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


@register("norm")
def _norm(p, c, a):
    return torch.sqrt(torch.sum(a * a)).reshape((1,))


def _arg_reduce(fn, p, a):
    ax = p["axis"]
    if ax is None:   # over the flattened array, a 0-d result
        return fn(a.reshape(-1), dim=0).to(a.dtype)
    return fn(a, dim=ax, keepdim=p["keepdims"]).to(a.dtype)


@register("argmax", params_spec=(_axis_param(), Param("keepdims", bool,
                                                      False)))
def _argmax(p, c, a):
    return _arg_reduce(torch.argmax, p, a)


@register("argmin", params_spec=(_axis_param(), Param("keepdims", bool,
                                                      False)))
def _argmin(p, c, a):
    return _arg_reduce(torch.argmin, p, a)


# ----------------------------------------------------------------------
# indexing
def one_hot(indices: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: indices truncated to integers; an index
    outside ``[0, depth)`` gives a row of zeros."""
    classes = torch.arange(depth, device=indices.device)
    return (indices.to(torch.int64).unsqueeze(-1) == classes).to(dtype)


@register("one_hot", params_spec=(Param("depth", int, required=True),
                                  Param("on_value", float, 1.0),
                                  Param("off_value", float, 0.0),
                                  Param("dtype", "dtype", torch.float32)),
          input_names=("indices",))
def _one_hot(p, c, indices):
    oh = one_hot(indices, p["depth"], p["dtype"])
    return oh * (p["on_value"] - p["off_value"]) + p["off_value"]


@register("where", input_names=("condition", "x", "y"))
def _where(p, c, cond, x, y):
    """``x`` where ``condition`` is nonzero, else ``y``; the condition
    gets no gradient, as through the JAX package's cast to bool."""
    return torch.where(cond.detach().to(torch.bool), x, y)


@register("zeros_like")
def _zeros_like(p, c, a):
    return torch.zeros_like(a)


@register("ones_like")
def _ones_like(p, c, a):
    return torch.ones_like(a)


# ----------------------------------------------------------------------
# the rest of the shape and layout ops: views where torch has one, plain
# torch ops otherwise, nothing read from the host
@register("SwapAxis", params_spec=(Param("dim1", int, 0),
                                   Param("dim2", int, 0)),
          hint="swapaxis")
def _swapaxis(p, c, a):
    return a.transpose(p["dim1"], p["dim2"])


alias("swapaxes", "SwapAxis")


@register("slice", params_spec=(Param("begin", "shape", required=True),
                                Param("end", "shape", required=True)))
def _slice(p, c, a):
    return a[tuple(slice(b, e) for b, e in zip(p["begin"], p["end"]))]


@register("Crop", params_spec=(Param("num_args", int, 1),
                               Param("offset", "shape", (0, 0)),
                               Param("h_w", "shape", (0, 0)),
                               Param("center_crop", bool, False)),
          input_names=lambda p: ["arg%d" % i for i in range(p["num_args"])],
          hint="crop")
def _crop(p, c, *xs):
    """A window of ``(N, C, H, W)`` data as a view: the second input's
    height and width (two inputs) or ``h_w`` (one), at ``offset`` or,
    with ``center_crop``, centred (the odd pixel on the far side)."""
    a = xs[0]
    th, tw = (xs[1].shape[2], xs[1].shape[3]) if len(xs) == 2 else p["h_w"]
    if p["center_crop"]:
        oy, ox = (a.shape[2] - th) // 2, (a.shape[3] - tw) // 2
    else:
        oy, ox = p["offset"]
    return a[:, :, oy:oy + th, ox:ox + tw]


def _pad_index(n, before, after, mode, device):
    """The source index of every padded position along an axis of
    length ``n``: clamped (edge) or mirrored without repeating the edge
    (reflect), numpy's ``pad`` modes."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@register("Pad", params_spec=(Param("pad_width", "shape", required=True),
                              Param("mode", str, "constant",
                                    enum=("constant", "edge", "reflect")),
                              Param("constant_value", float, 0.0)),
          hint="pad")
def _pad(p, c, a):
    """``jnp.pad`` with ``pad_width`` given as (before, after) pairs for
    every axis, flattened: a constant fill, or each padded axis gathered
    through its edge or mirror index."""
    pw = p["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(a.ndim)]
    if p["mode"] == "constant":
        return F.pad(a, [q for lo, hi in reversed(pairs) for q in (lo, hi)],
                     value=p["constant_value"])
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            a = a.index_select(ax, _pad_index(a.shape[ax], lo, hi,
                                              p["mode"], a.device))
    return a


alias("pad", "Pad")


@register("tile", params_spec=(Param("reps", "shape", required=True),))
def _tile(p, c, a):
    return torch.tile(a, p["reps"])


@register("repeat", params_spec=(Param("repeats", int, required=True),
                                 _axis_param()))
def _repeat(p, c, a):
    """``jnp.repeat``: every element ``repeats`` times along ``axis``,
    over the flattened array without one."""
    return a.repeat_interleave(p["repeats"], dim=p["axis"])


@register("reverse", params_spec=(_axis_param("axis", required=True),))
def _reverse(p, c, a):
    ax = p["axis"]
    return torch.flip(a, dims=ax if isinstance(ax, tuple) else (ax,))


alias("flip", "reverse")


@register("broadcast_axis", params_spec=(_axis_param(),
                                         Param("size", "shape", ())))
def _broadcast_axis(p, c, a):
    ax = p["axis"]
    axes = (ax,) if isinstance(ax, int) else (ax or ())
    shape = list(a.shape)
    for x, s in zip(axes, p["size"]):
        shape[x] = s
    return a.expand(shape)


alias("broadcast_axes", "broadcast_axis")


# ----------------------------------------------------------------------
# ordering: a stable sort keeps tied elements in index order, as
# ``lax.top_k`` and ``jnp.argsort`` do
@register("argmax_channel")
def _argmax_channel(p, c, a):
    return torch.argmax(a, dim=1).to(a.dtype)


@register("topk", params_spec=(_axis_param("axis", -1), Param("k", int, 1),
                               Param("ret_typ", str, "indices",
                                     enum=("value", "indices", "mask",
                                           "both")),
                               Param("is_ascend", bool, False)),
          num_outputs=lambda p: 2 if p.get("ret_typ") == "both" else 1)
def _topk(p, c, a):
    """The ``k`` largest (smallest with ``is_ascend``) entries along
    ``axis``: their values, their indices in the input's dtype, both,
    or a mask of ones at them."""
    ax = p["axis"] if p["axis"] is not None else a.ndim - 1
    k = p["k"]
    src = a.movedim(ax, -1)
    key = -src if p["is_ascend"] else src
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    if p["ret_typ"] == "mask":
        mask = torch.zeros_like(src).scatter(-1, idx, 1.0)
        return mask.movedim(-1, ax)
    vals = src.gather(-1, idx).movedim(-1, ax)
    idx = idx.movedim(-1, ax).to(a.dtype)
    if p["ret_typ"] == "value":
        return vals
    if p["ret_typ"] == "indices":
        return idx
    return vals, idx


@register("sort", params_spec=(_axis_param("axis", -1),
                               Param("is_ascend", bool, True)))
def _sort(p, c, a):
    """``axis=None`` sorts the flattened array, as ``jnp.sort`` does."""
    ax = p["axis"]
    if ax is None:
        a, ax = a.reshape(-1), 0
    out = torch.sort(a, dim=ax, stable=True).values
    return out if p["is_ascend"] else torch.flip(out, dims=(ax,))


@register("argsort", params_spec=(_axis_param("axis", -1),
                                  Param("is_ascend", bool, True)))
def _argsort(p, c, a):
    """``axis=None`` orders the flattened array, as ``jnp.argsort``."""
    ax = p["axis"]
    if ax is None:
        ax = 0
    idx = torch.argsort(a.reshape(-1) if p["axis"] is None else a, dim=ax,
                        stable=True)
    if not p["is_ascend"]:
        idx = torch.flip(idx, dims=(ax,))
    return idx.to(a.dtype)


# ----------------------------------------------------------------------
# the rest of indexing
def _in_range(idx, n):
    """Integer indices as the JAX package's ``batch_take`` reads them:
    negative indices count from the end, then clamp into ``[0, n)``
    (``pick`` fills past the axis instead, ``_pick``)."""
    idx = idx.detach().to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register("take", params_spec=(Param("axis", int, 0),
                               Param("mode", str, "clip",
                                     enum=("clip", "wrap", "raise"))),
          input_names=("a", "indices"))
def _take(p, c, a, indices):
    """``jnp.take``: indices truncated to integers, clamped into the
    axis (``clip``, also for ``raise``, as the JAX op reads it) or
    wrapped around it (``wrap``)."""
    ax = p["axis"] % a.ndim
    n = a.shape[ax]
    idx = indices.detach().to(torch.int64)
    idx = idx.remainder(n) if p["mode"] == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take", input_names=("a", "indices"))
def _batch_take(p, c, a, indices):
    """``a[i, indices[i]]`` for every row ``i``."""
    rows = torch.arange(a.shape[0], device=a.device)
    return a[rows, _in_range(indices, a.shape[1])]


@register("pick", params_spec=(_axis_param("axis", -1),
                               Param("keepdims", bool, False)),
          input_names=("data", "index"))
def _pick(p, c, a, index):
    """One element along ``axis`` a position, at ``index``, as
    ``jnp.take_along_axis`` reads it: an index in ``[-n, n)`` wraps as
    in numpy; any other fills its place (NaN for floating types, the
    type's lowest value for signed ones, its highest for unsigned ones
    and True for bool), where the gradient is zero."""
    ax = p["axis"] if p["axis"] is not None else a.ndim - 1
    ax %= a.ndim
    n = a.shape[ax]
    raw = index.detach().to(torch.int64).unsqueeze(ax)
    inside = (raw >= -n) & (raw < n)
    out = a.gather(ax, _in_range(raw, n))
    out = torch.where(inside, out, _fill_value(a.dtype))
    return out if p["keepdims"] else out.squeeze(ax)


def _fill_value(dtype):
    """What ``jnp``'s out-of-bounds gather fills for ``dtype``."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed \
        else torch.iinfo(dtype).max


# ----------------------------------------------------------------------
# gradient-flow control and plumbing
@register("BlockGrad", hint="blockgrad")
def _block_grad(p, c, a):
    return a.detach()


alias("stop_gradient", "BlockGrad")


@register("make_loss_internal")
def _make_loss_internal(p, c, a):
    return a


@register("_identity_with_attr_like_rhs", input_names=("lhs", "rhs"))
def _identity_attr_like(p, c, lhs, rhs):
    return lhs


@register("_CrossDeviceCopy", hint="crossdevicecopy")
def _cross_device_copy(p, c, a):
    """On one device a copy between devices is the identity, as inside
    the JAX package's one program."""
    return a
