"""Optimizer updates for the fused train step
(``mxnet_tpu/parallel/optim.py``).

Every optimizer with a pure ``_rule(w, g, state, lr, wd, t)`` (see
``optimizer.py``) has its math in that one function.  The classic path
updates one weight at a time in place; here the same rule runs over
every parameter inside the one step, which the Trainer captures in a
CUDA graph on the card.

``make_update_fn(optimizer, param_names)`` returns ``(init_fn,
update_fn)`` honouring the per-name lr/wd multipliers (biases and norm
shifts default to wd 0, as ``Optimizer.set_wd_mult`` does).  The
state-sharding planners of the JAX module wait for the port's mesh
slice.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

from ..base import MXNetError
from .. import optimizer as _opt

__all__ = ["make_update_fn"]


def _supports_fusion(optimizer):
    return (not optimizer.has_noise and
            type(optimizer)._rule is not _opt.Optimizer._rule)


def make_update_fn(optimizer: "_opt.Optimizer", param_names: List[str]
                   ) -> Tuple[Callable, Callable]:
    """``init_fn(params) -> state`` and ``update_fn(params, grads, state,
    lr, t) -> (params, state)``, each on dicts by parameter name.  ``lr``
    and ``t`` may be 0-d device tensors, read when the step runs."""
    if not _supports_fusion(optimizer):
        raise MXNetError(
            "optimizer %s has no pure fused-step rule; Module falls back "
            "to the per-weight imperative update path"
            % type(optimizer).__name__)

    def scales(name):
        lr_mult = optimizer.lr_mult.get(name, 1.0)
        wd_default = 1.0 if name.endswith(("_weight", "_gamma")) else 0.0
        wd = optimizer.wd * optimizer.wd_mult.get(name, wd_default)
        return lr_mult, wd

    def init_fn(params):
        return {n: optimizer._state(params[n]) for n in param_names}

    def update_fn(params, grads, state, lr, t):
        new_params, new_state = {}, {}
        for n in param_names:
            lr_mult, wd = scales(n)
            new_params[n], new_state[n] = optimizer._rule(
                params[n], grads[n], state[n], lr * lr_mult, wd, t)
        return new_params, new_state

    return init_fn, update_fn
