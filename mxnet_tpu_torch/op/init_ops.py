"""Creation and sampling ops (``mxnet_tpu/op/init_ops.py``).

An op without tensor inputs creates its output on ``OpContext.device``:
the executor's device, or the imperative call's ``ctx`` (else the current
context).  Samplers draw from ``OpContext.rng``, that device's
``torch.Generator`` (``random.py``): deterministic per seed, but other
numbers than the JAX package's threefry keys give.
"""
from __future__ import annotations

import torch

from .registry import Param, register, alias


def _creation_spec():
    return (Param("shape", "shape", required=True),
            Param("ctx", str, None),
            Param("dtype", "dtype", torch.float32))


def _concrete(shape):
    """MXNet shape semantics: dim 0 = unknown.  Creation ops materialize
    unknown dims as broadcastable size-1 (an RNN's ``begin_state`` zeros
    of shape ``(0, h)`` meet real activations by broadcasting)."""
    return tuple(1 if d == 0 else d for d in shape)


register("_zeros", lambda p, c: torch.zeros(_concrete(p["shape"]),
                                            dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec(), input_names=())
register("_ones", lambda p, c: torch.ones(_concrete(p["shape"]),
                                          dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec(), input_names=())
register("_full", lambda p, c: torch.full(_concrete(p["shape"]), p["value"],
                                          dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec() + (Param("value", float,
                                               required=True),),
         input_names=())
alias("zeros", "_zeros")
alias("ones", "_ones")
alias("full", "_full")


@register("_arange", params_spec=(
    Param("start", float, 0.0),
    Param("stop", lambda v: None if v in (None, "None") else float(v), None),
    Param("step", float, 1.0),
    Param("repeat", int, 1),
    Param("ctx", str, None),
    Param("dtype", "dtype", torch.float32)),
    input_names=())
def _arange_op(p, c):
    start, stop = p["start"], p["stop"]
    if stop is None:            # arange(n) == arange(0, n), as numpy reads it
        start, stop = 0.0, start
    vals = torch.arange(start, stop, p["step"], dtype=torch.float64,
                        device=c.device).to(p["dtype"])
    if p["repeat"] != 1:
        vals = vals.repeat_interleave(p["repeat"])
    return vals


# ----------------------------------------------------------------------
def _sample_spec(*extra):
    return extra + (Param("shape", "shape", ()),
                    Param("ctx", str, None),
                    Param("dtype", "dtype", torch.float32))


def _reg_sampler(name, spec, fn, aliases=()):
    register(name, fn, params_spec=_sample_spec(*spec), input_names=(),
             uses_rng=True)
    for al in aliases:
        alias(al, name)


def _empty(p, c):
    return torch.empty(p["shape"] or (1,), dtype=p["dtype"], device=c.device)


_reg_sampler(
    "_sample_uniform", (Param("low", float, 0.0), Param("high", float, 1.0)),
    lambda p, c: _empty(p, c).uniform_(p["low"], p["high"], generator=c.rng),
    aliases=("uniform", "random_uniform", "_random_uniform"))

_reg_sampler(
    "_sample_normal", (Param("loc", float, 0.0), Param("scale", float, 1.0)),
    lambda p, c: _empty(p, c).normal_(p["loc"], p["scale"], generator=c.rng),
    aliases=("normal", "random_normal", "_random_normal"))
