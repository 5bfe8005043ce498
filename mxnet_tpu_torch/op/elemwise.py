"""Elementwise / broadcast / scalar op families (``mxnet_tpu/op/elemwise.py``).

Each op is the torch expression of the JAX package's ``jax.numpy`` one,
with its numerics: ``mod`` is Python's modulo (the sign follows the
divisor: ``torch.remainder``, not ``torch.fmod``), ``round`` and ``rint``
round half to even, ``fix`` truncates, ``gamma`` is ``exp(gammaln)`` (so
positive where Γ is negative), ``cbrt`` of a negative number is
negative, ``softrelu`` is ``log(1 + exp(x))`` with no threshold, and the
comparisons return the input's dtype.
"""
from __future__ import annotations

import torch

from .registry import Param, register, alias

_SCALAR = (Param("scalar", float, required=True),)


def _scalar_as(a, s):
    # the scalar in the array's dtype, as the JAX package casts it: an
    # int array stays int under a float scalar.  A fill on the array's
    # device: a tensor made from host data would be a copy from the
    # host, which a CUDA graph's capture refuses
    return torch.full((), s, dtype=a.dtype, device=a.device)


def _reg_binary_scalar(name, fn):
    register(name, lambda p, c, a, _fn=fn: _fn(a, _scalar_as(a, p["scalar"])),
             params_spec=_SCALAR)


def _softplus(a):
    return torch.logaddexp(a, torch.zeros_like(a))


def _cbrt(a):
    return torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)


# --- binary elementwise + their broadcast_* and scalar twins ----------
_BINARY = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul,
           "div": torch.div, "mod": torch.remainder, "power": torch.pow,
           "maximum": torch.maximum, "minimum": torch.minimum,
           "hypot": torch.hypot}
_BROADCAST_NAME = {"plus": "add", "minus": "sub"}
_CMP = {"equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
        "greater_equal": torch.ge, "lesser": torch.lt,
        "lesser_equal": torch.le}

for _name, _fn in _BINARY.items():
    register("_" + _name, lambda p, c, a, b, _fn=_fn: _fn(a, b),
             input_names=("lhs", "rhs"))
    register("broadcast_" + _BROADCAST_NAME.get(_name, _name),
             lambda p, c, a, b, _fn=_fn: _fn(a, b), input_names=("lhs", "rhs"))
    _reg_binary_scalar("_%s_scalar" % _name, _fn)

for _name, _fn in _CMP.items():
    # comparisons give 0/1 in the input's dtype, like the reference
    # (mshadow_op.h eq/ne/...)
    _cmp = (lambda a, b, _fn=_fn: _fn(a, b).to(a.dtype))
    register("_" + _name, lambda p, c, a, b, _cmp=_cmp: _cmp(a, b),
             input_names=("lhs", "rhs"))
    register("broadcast_" + _name, lambda p, c, a, b, _cmp=_cmp: _cmp(a, b),
             input_names=("lhs", "rhs"))
    _reg_binary_scalar("_%s_scalar" % _name, _cmp)

# the scalar on the left: 1 - x, 1 / x, 3 % x, 2 ** x
for _name, _fn in (("minus", torch.sub), ("div", torch.div),
                   ("mod", torch.remainder), ("power", torch.pow)):
    _reg_binary_scalar("_r%s_scalar" % _name,
                       lambda a, s, _fn=_fn: _fn(s, a))

alias("elemwise_add", "_plus")
alias("elemwise_sub", "_minus")
alias("elemwise_mul", "_mul")
alias("elemwise_div", "_div")
alias("_add", "_plus")
alias("_sub", "_minus")
alias("_grad_add", "_plus")
alias("_Plus", "_plus")
alias("_Minus", "_minus")
alias("_Mul", "_mul")
alias("_Div", "_div")

# --- unary math --------------------------------------------------------
_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "round": torch.round, "square": torch.square,
    "sqrt": torch.sqrt, "rsqrt": lambda a: 1.0 / torch.sqrt(a),
    "cbrt": _cbrt, "rcbrt": lambda a: 1.0 / _cbrt(a),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "gamma": lambda a: torch.exp(torch.lgamma(a)),
    "gammaln": torch.lgamma,
    "negative": torch.neg,
    "reciprocal": lambda a: 1.0 / a,
    "sigmoid": torch.sigmoid,
    "softrelu": _softplus,
    "erf": torch.erf,
}
for _name, _fn in _UNARY.items():
    register(_name, lambda p, c, a, _fn=_fn: _fn(a))

register("relu", lambda p, c, a: torch.relu(a))
register("identity", lambda p, c, a: a)
alias("_copy", "identity")


@register("clip", params_spec=(Param("a_min", float, required=True),
                               Param("a_max", float, required=True)))
def _clip(p, c, a):
    return torch.clamp(a, p["a_min"], p["a_max"])


@register("smooth_l1", params_spec=(Param("scalar", float, 1.0),))
def _smooth_l1(p, c, a):
    s2 = p["scalar"] ** 2
    absd = torch.abs(a)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * a * a, absd - 0.5 / s2)


def _sum_n(p, c, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


register("add_n", _sum_n,
         params_spec=(Param("num_args", int, required=True),),
         input_names=lambda p: ["arg%d" % i for i in range(p["num_args"])])
alias("ElementWiseSum", "add_n")
alias("_sum_n", "add_n")
