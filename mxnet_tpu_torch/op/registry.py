"""Unified operator registry.

The PyTorch counterpart of ``mxnet_tpu/op/registry.py``: an op is a plain
function on tensors plus metadata.  Shape inference defaults to running
the op body on ``device="meta"`` tensors (the op *is* its own shape
function, as ``jax.eval_shape`` makes it in the JAX package); ops whose
parameter shapes must be inferred backwards from the data
(FullyConnected's ``weight``) provide ``infer_shape``.

Every registered op gets a symbolic front-end ``mx.sym.<Name>(...)``.
"""
from __future__ import annotations

import ast
import difflib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, _dtype

_REGISTRY: Dict[str, "Op"] = {}
_ALIASES: Dict[str, str] = {}

_META = torch.device("meta")


class OpContext:
    """Runtime context threaded into every op body.

    ``is_train`` selects mode-dependent behaviour (Dropout).  ``record``
    says whether torch autograd records the body: the executor records
    exactly when it trains; an imperative call records inside
    ``autograd.record()``, whatever its mode.  ``device`` is where ops
    without tensor inputs (``_arange``, ``_zeros``) create their output:
    the executor's device, the imperative call's context, or ``meta``
    during shape inference.  ``rng`` is that device's ``torch.Generator``,
    which ops that declared ``uses_rng`` draw from (the reference's
    ``ResourceRequest::kRandom``); None where nothing draws.
    ``dtype_policy`` selects the backward formulations
    (``op/bytediet.py``): ``"bytediet"``, ``"legacy"``, or None for the
    process default.  ``batch_sum``, where the rows of one batch lie on
    ``batch_ranks`` ranks of a data mesh, sums a tensor over those ranks
    (differentiably): BatchNorm's statistics then cover the whole batch.
    """

    __slots__ = ("is_train", "record", "device", "rng", "dtype_policy",
                 "batch_sum", "batch_ranks")

    def __init__(self, is_train=False, device=None, rng=None, record=None,
                 dtype_policy=None, batch_sum=None, batch_ranks=1):
        self.is_train = is_train
        self.record = is_train if record is None else record
        self.device = torch.device("cpu") if device is None else device
        self.rng = rng
        self.dtype_policy = dtype_policy
        self.batch_sum = batch_sum
        self.batch_ranks = batch_ranks


def _parse_bool(v):
    if isinstance(v, str):
        return v.lower() in ("true", "1", "yes")
    return bool(v)


def _parse_shape(v):
    if v is None:
        return None
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x) for x in v)


def _parse_floats(v):
    """Tuple-of-floats params ('(0.1, 0.2)' strings, scalars, sequences)."""
    if v is None:
        return None
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float, np.floating, np.integer)):
        return (float(v),)
    return tuple(float(x) for x in v)


_COERCE = {
    int: lambda v: int(float(v)) if isinstance(v, str) else int(v),
    float: float,
    bool: _parse_bool,
    str: str,
    "shape": _parse_shape,
    "floats": _parse_floats,
    "dtype": _dtype,
}


@dataclass
class Param:
    """Typed op parameter — the dmlc::Parameter equivalent.

    Values coerce from strings at call time, so symbols loaded from JSON
    (all-string attrs) get the same typed params as symbols built in
    Python.
    """

    name: str
    type: Any = float
    default: Any = None
    required: bool = False
    enum: Optional[Sequence[str]] = None

    def coerce(self, v):
        if v is None:
            return None
        v = _COERCE.get(self.type, self.type)(v)
        if self.enum is not None and v not in self.enum:
            raise MXNetError(
                "param %s expects one of %s, got %r" % (self.name, self.enum, v))
        return v


@dataclass
class Op:
    """A registered operator."""

    name: str
    fn: Callable  # fn(params: dict, ctx: OpContext, *tensors) -> tensor | tuple
    params_spec: Tuple[Param, ...] = ()
    # input names; a callable receives parsed params (e.g. FC drops 'bias'
    # when no_bias=True — reference fully_connected-inl.h ListArguments)
    input_names: Any = ("data",)
    aux_names: Any = ()
    num_outputs: Any = 1  # int or callable(params) -> int
    output_names: Any = None  # callable(params) -> names; default ["output"]
    infer_shape: Optional[Callable] = None  # (params, in_shapes) -> (in,out,aux)
    infer_dtype: Optional[Callable] = None
    uses_rng: bool = False  # the body draws from ``OpContext.rng``
    # the body draws in an inference forward too; None inherits
    # ``uses_rng`` (the RNN op says False: its dropout draws only in
    # training)
    rng_in_eval: Optional[bool] = None
    # the body's result depends on ``OpContext.is_train`` (Dropout)
    mode_dependent: bool = False
    # the body runs Python on the host (a Custom op): a graph holding it
    # is never captured in a CUDA graph
    python_body: bool = False
    hint: str = ""  # auto-naming hint, defaults to lowercased name

    def __post_init__(self):
        if self.rng_in_eval is None:
            self.rng_in_eval = self.uses_rng

    def list_inputs(self, params) -> List[str]:
        names = self.input_names(params) if callable(self.input_names) \
            else self.input_names
        return list(names)

    def list_aux(self, params) -> List[str]:
        names = self.aux_names(params) if callable(self.aux_names) \
            else self.aux_names
        return list(names)

    def n_outputs(self, params) -> int:
        return self.num_outputs(params) if callable(self.num_outputs) \
            else self.num_outputs

    def list_outputs(self, params) -> List[str]:
        if self.output_names is not None:
            return list(self.output_names(params))
        n = self.n_outputs(params)
        return ["output"] if n == 1 else ["output%d" % i for i in range(n)]

    # ------------------------------------------------------------------
    def parse_params(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        params = {}
        spec = {p.name: p for p in self.params_spec}
        for k, v in kwargs.items():
            if k in spec:
                params[k] = spec[k].coerce(v)
            elif k.startswith("__") and k.endswith("__"):
                # dunder group attrs (__lr_mult__ and kin) ride through
                # untouched: op bodies never read them, serialization
                # keeps them with the node
                params[k] = v
            else:
                close = difflib.get_close_matches(k, spec, n=1)
                hint = "; did you mean %r?" % close[0] if close else ""
                raise MXNetError(
                    "%s got unknown parameter %r%s (known parameters: %s)"
                    % (self.name, k, hint, sorted(spec) or "none"))
        for p in self.params_spec:
            if p.name not in params:
                if p.required:
                    raise MXNetError(
                        "%s missing required parameter %r" % (self.name, p.name))
                params[p.name] = p.default
        return params

    # ------------------------------------------------------------------
    def apply(self, params, ctx: OpContext, *tensors):
        """Run the op body; returns (outputs_tuple, aux_updates_tuple).

        The body runs under torch autograd when ``ctx.record`` holds and
        an input requires a gradient, and without it otherwise."""
        grad = ctx.record and any(t.requires_grad for t in tensors)
        with torch.set_grad_enabled(grad):
            out = self.fn(params, ctx, *tensors)
        if not isinstance(out, tuple):
            out = (out,)
        n_out = self.n_outputs(params)
        n_aux = len(self.list_aux(params))
        if len(out) != n_out + n_aux:
            raise MXNetError(
                "%s returned %d tensors, expected %d outputs + %d aux" %
                (self.name, len(out), n_out, n_aux))
        return out[:n_out], out[n_out:]

    # ------------------------------------------------------------------
    def infer_shape_generic(self, params, in_shapes):
        """Shape inference: the op's own ``infer_shape`` when it has one,
        else the op body run on meta tensors."""
        in_shapes = list(in_shapes)
        if self.infer_shape is not None:
            ret = self.infer_shape(params, in_shapes)
            if ret is not None:
                in_s, out_s, aux_s = ret
                return list(in_s), list(out_s), list(aux_s)
        if any(s is None or any(d == 0 for d in s) for s in in_shapes):
            # same-shape propagation for unknown inputs
            known = [s for s in in_shapes
                     if s is not None and all(d != 0 for d in s)]
            if known and all(s is None or s == known[0] for s in in_shapes):
                in_shapes = [known[0]] * len(in_shapes)
            else:
                raise MXNetError(
                    "cannot infer shapes for %s from %s" % (self.name, in_shapes))
        dt = params.get("dtype") or torch.float32
        metas = [torch.empty(tuple(s), dtype=dt, device=_META)
                 for s in in_shapes]
        out = self.fn(params, OpContext(is_train=False, device=_META), *metas)
        if not isinstance(out, tuple):
            out = (out,)
        n_out = self.n_outputs(params)
        out_shapes = [tuple(o.shape) for o in out[:n_out]]
        aux_out = [tuple(o.shape) for o in out[n_out:]]
        return in_shapes, out_shapes, aux_out

    def infer_dtype_generic(self, params, in_dtypes):
        if self.infer_dtype is not None:
            return self.infer_dtype(params, in_dtypes)
        known = [d for d in in_dtypes if d is not None]
        dt = known[0] if known else torch.float32
        in_dtypes = [d if d is not None else dt for d in in_dtypes]
        # an explicit ``dtype`` param DEFINES the output dtype
        out_dt = params.get("dtype") if params else None
        out_dt = out_dt if out_dt is not None else dt
        n_out = self.n_outputs(params)
        n_aux = len(self.list_aux(params))
        return in_dtypes, [out_dt] * n_out, [out_dt] * n_aux


def register(name, fn=None, **kwargs) -> Callable:
    """Register an op.  Usable as decorator or direct call."""

    def _do(f):
        op = Op(name=name, fn=f,
                hint=kwargs.pop("hint", name.lstrip("_").lower()), **kwargs)
        _REGISTRY[name] = op
        return f

    if fn is not None:
        return _do(fn)
    return _do


def alias(alias_name, target):
    _ALIASES[alias_name] = target


def get(name) -> Op:
    if name in _ALIASES:
        name = _ALIASES[name]
    if name not in _REGISTRY:
        raise MXNetError("operator %r is not registered" % name)
    return _REGISTRY[name]

