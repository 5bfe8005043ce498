"""Elementwise / broadcast ops (``mxnet_tpu/op/elemwise.py``): the
arithmetic families behind the Symbol's operators and the transformer's
residuals and position embedding."""
from __future__ import annotations

import torch

from .registry import Param, register, alias

_BINARY = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul,
           "div": torch.div, "power": torch.pow}
_BROADCAST_NAME = {"plus": "add", "minus": "sub"}
_SCALAR = (Param("scalar", float, required=True),)


def _scalar_as(a, s):
    # the scalar in the array's dtype, as the JAX package casts it: an
    # int array stays int under a float scalar
    return torch.as_tensor(s, dtype=a.dtype, device=a.device)


for _name, _fn in _BINARY.items():
    register("_" + _name, lambda p, c, a, b, _fn=_fn: _fn(a, b),
             input_names=("lhs", "rhs"))
    register("broadcast_" + _BROADCAST_NAME.get(_name, _name),
             lambda p, c, a, b, _fn=_fn: _fn(a, b), input_names=("lhs", "rhs"))
    register("_%s_scalar" % _name,
             lambda p, c, a, _fn=_fn: _fn(a, _scalar_as(a, p["scalar"])),
             params_spec=_SCALAR)
    if _name in ("minus", "div", "power"):
        # the scalar on the left: 1 - x, 1 / x, 2 ** x
        register("_r%s_scalar" % _name,
                 lambda p, c, a, _fn=_fn: _fn(_scalar_as(a, p["scalar"]), a),
                 params_spec=_SCALAR)

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
