"""Optimizer update ops (``mxnet_tpu/op/optimizer_op.py``).

The reference registers ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update`` as ops
(``src/operator/optimizer_op.cc:18-98``), so an update runs where the
weight lies.  Each is here a few torch operations on the device of its
inputs, as the JAX package's are ``jnp`` expressions; both share
``_prep_grad``: rescale, clip (when ``clip_gradient > 0``), then weight
decay.  The ops return new tensors; ``mt.nd.<op>(..., out=weight)``
writes the result back, as the reference's in-place calls do.
"""
from __future__ import annotations

import torch

from .registry import Param, register


def _common(*extra):
    return extra + (
        Param("lr", float, required=True),
        Param("wd", float, 0.0),
        Param("rescale_grad", float, 1.0),
        Param("clip_gradient", float, -1.0),
    )


def _prep_grad(p, weight, grad):
    grad = grad * p["rescale_grad"]
    if p["clip_gradient"] is not None and p["clip_gradient"] > 0:
        grad = grad.clamp(-p["clip_gradient"], p["clip_gradient"])
    return grad + p["wd"] * weight


def _f32(v, like):
    """A Python number as a 0-d float32 tensor on ``like``'s device: the
    JAX op forms its scalar coefficients in float32."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


@register("sgd_update", params_spec=_common(), input_names=("weight", "grad"))
def _sgd_update(p, c, weight, grad):
    return weight - p["lr"] * _prep_grad(p, weight, grad)


@register("sgd_mom_update", params_spec=_common(Param("momentum", float, 0.0)),
          input_names=("weight", "grad", "mom"), num_outputs=2)
def _sgd_mom_update(p, c, weight, grad, mom):
    g = _prep_grad(p, weight, grad)
    mom = p["momentum"] * mom - p["lr"] * g
    return weight + mom, mom


@register("adam_update",
          params_spec=_common(Param("beta1", float, 0.9),
                              Param("beta2", float, 0.999),
                              Param("epsilon", float, 1e-8),
                              Param("t", int, 1)),
          input_names=("weight", "grad", "mean", "var"), num_outputs=3)
def _adam_update(p, c, weight, grad, mean, var):
    g = _prep_grad(p, weight, grad)
    mean = p["beta1"] * mean + (1 - p["beta1"]) * g
    var = p["beta2"] * var + (1 - p["beta2"]) * g * g
    t = p["t"]
    coef = p["lr"] * torch.sqrt(_f32(1 - p["beta2"] ** t, weight)) \
        / (1 - p["beta1"] ** t)
    weight = weight - coef * mean / (torch.sqrt(var) + p["epsilon"])
    return weight, mean, var


@register("rmsprop_update",
          params_spec=_common(Param("gamma1", float, 0.95),
                              Param("epsilon", float, 1e-8),
                              Param("clip_weights", float, -1.0)),
          input_names=("weight", "grad", "n"), num_outputs=2)
def _rmsprop_update(p, c, weight, grad, n):
    g = _prep_grad(p, weight, grad)
    n = (1 - p["gamma1"]) * g * g + p["gamma1"] * n
    weight = weight - p["lr"] * g / torch.sqrt(n + p["epsilon"])
    if p["clip_weights"] and p["clip_weights"] > 0:
        weight = weight.clamp(-p["clip_weights"], p["clip_weights"])
    return weight, n


@register("rmspropalex_update",
          params_spec=_common(Param("gamma1", float, 0.95),
                              Param("gamma2", float, 0.9),
                              Param("epsilon", float, 1e-8),
                              Param("clip_weights", float, -1.0)),
          input_names=("weight", "grad", "n", "g", "delta"), num_outputs=4)
def _rmspropalex_update(p, c, weight, grad, n, g_state, delta):
    """Graves' centered RMSProp.  ``clip_weights > 0`` clips the new
    weight, as the reference's op does (the JAX op ignores it)."""
    g = _prep_grad(p, weight, grad)
    n = (1 - p["gamma1"]) * g * g + p["gamma1"] * n
    g_state = (1 - p["gamma1"]) * g + p["gamma1"] * g_state
    delta = (p["gamma2"] * delta
             - p["lr"] * g / torch.sqrt(n - g_state * g_state + p["epsilon"]))
    weight = weight + delta
    if p["clip_weights"] and p["clip_weights"] > 0:
        weight = weight.clamp(-p["clip_weights"], p["clip_weights"])
    return weight, n, g_state, delta
