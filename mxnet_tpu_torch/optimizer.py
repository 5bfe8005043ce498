"""Optimizers (``mxnet_tpu/optimizer.py``).

The class surface of the reference's optimizer module
(``python/mxnet/optimizer.py``): the :class:`Optimizer` base with its
registry, update counting, ``rescale_grad``, ``wd``, ``clip_gradient``,
lr/wd multipliers (from the symbol's ``__lr_mult__``/``__wd_mult__``
attributes and by name) and ``lr_scheduler``; SGD (momentum), ccSGD,
NAG, SGLD, DCASGD, Adam, AdaGrad, RMSProp (plain and centered), AdaDelta,
Ftrl and Test; :func:`create`, and :func:`get_updater`, whose states
round-trip through ``get_states``/``set_states``.

Each class has the JAX package's pure form of its math: ``_state(w)``
makes a weight's state and ``_rule(w, g, state, lr, wd, t)`` returns the
new weight and state as new tensors, touching none of its inputs (SGLD's
takes the device's ``torch.Generator`` too).  ``lr`` and ``t`` may be
0-d device tensors, so a step captured in a CUDA graph reads them at
every replay instead of baking them in.  The fused step
(:func:`mxnet_tpu_torch.parallel.optim.make_update_fn`) applies that
rule to every parameter.  The classic path's :meth:`Optimizer.update`
runs the same rule on one weight's tensors and copies the results into
the weight and its state, on the device they lie on, as the JAX
package's jitted update does.  SGD and Adam keep an in-place update of
their own beside their rule (the same operations in the same order;
their bias correction and scalars round in float64 there).
"""
from __future__ import annotations

import logging
import math
import pickle

import torch

from .base import MXNetError
from .ndarray import NDArray
from . import random as _random

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "SGLD", "DCASGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Test", "Updater",
           "create", "get_updater", "register"]


def _map(fn, tree):
    """``fn`` over the leaves of a None/leaf/tuple state tree."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


class Optimizer(object):
    """Base: registry, update counting, lr/wd multiplier tables and the
    gradient preprocessing every rule shares."""

    opt_registry = {}
    has_noise = False           # the rule draws random numbers (SGLD)

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.num_update = self.begin_num_update = begin_num_update
        self._index_update_count = {}
        if param_idx2name is not None \
                and not isinstance(param_idx2name, dict):
            raise MXNetError(
                "param_idx2name should be a dict of param indexes to names.")
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry -------------------------------------------------------
    @staticmethod
    def register(klass):
        key = klass.__name__.lower()
        if key in Optimizer.opt_registry:
            logging.warning("WARNING: New optimizer %s.%s is overriding "
                            "existing optimizer %s", klass.__module__,
                            klass.__name__, key)
        Optimizer.opt_registry[key] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        try:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        except KeyError:
            raise ValueError("Cannot find optimizer %s" % name)

    # -- multiplier tables ----------------------------------------------
    def _attr_table(self, attr_key):
        """``__lr_mult__``-style per-argument attributes of the symbol."""
        table = {}
        if self.sym is not None:
            attrs = self.sym.attr_dict()
            for arg in self.sym.list_arguments():
                val = attrs.get(arg, {}).get(attr_key)
                if val is not None:
                    table[arg] = float(val)
        return table

    def set_lr_scale(self, args_lrscale):
        raise DeprecationWarning("Use set_lr_mult instead.")

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._attr_table("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases and norm shifts decay at 0 unless told otherwise
        self.wd_mult = {
            n: 0.0 for n in self.idx2name.values()
            if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._attr_table("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _mult_for(self, table, index, default=1.0):
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), default)

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)
        return base * self._mult_for(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult_for(self.wd_mult, index)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _step(self, index):
        """``(lr, wd, t)`` of this update of ``index``: lr reads the count
        before this update, the step ``t`` the per-index count after it,
        as in the reference."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        return lr, wd, self._index_update_count[index]

    def _prep_grad(self, g, w, wd):
        """Rescale, clip, add weight decay: a new tensor (``g`` and ``w``
        stay as they are)."""
        g = g * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = g.clamp_(-self.clip_gradient, self.clip_gradient)
        return g.add_(w, alpha=wd)

    # -- the pure rule ---------------------------------------------------
    def _state(self, w):
        """A weight's state from the weight tensor (None: stateless)."""
        return None

    def _rule(self, w, g, state, lr, wd, t):
        """``(new weight, new state)`` from the weight, its gradient, its
        state, the learning rate, the weight decay and the step ``t``."""
        raise NotImplementedError()

    # -- per-weight (the classic path) -----------------------------------
    def create_state(self, index, weight):
        """Per-weight state as (possibly nested) NDArrays, or None."""
        return _map(NDArray, self._state(weight.data))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """Update ``weight`` (and ``state``) in place from ``grad``: the
        rule on their tensors, its results copied back (the state's
        first, so a state that snapshots the weight reads the old one)."""
        lr, wd, t = self._step(index)
        noise = (_random.generator(weight.data.device),) \
            if self.has_noise else ()
        new_w, new_state = self._rule(
            weight.data, grad.data, _map(lambda a: a.data, state), lr, wd, t,
            *noise)
        for holder, value in zip(_leaves(state), _leaves(new_state)):
            holder.data.copy_(value)
        weight.data.copy_(new_w)


register = Optimizer.register


@register
class SGD(Optimizer):
    """(Momentum) SGD, the reference's ``sgd_update`` /
    ``sgd_mom_update`` (``src/operator/optimizer_op.cc:18-60``):
    ``mom = momentum * mom - lr * g; w += mom``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, _ = self._step(index)
        w = weight.data
        g = self._prep_grad(grad.data, w, wd)
        if state is None:
            w.sub_(g.mul_(lr))
            return
        mom = state.data
        mom.mul_(self.momentum).sub_(g.mul_(lr))
        w.add_(mom)

    def _state(self, w):
        return torch.zeros_like(w) if self.momentum else None

    def _rule(self, w, g, mom, lr, wd, t):
        g = self._prep_grad(g, w, wd)
        if mom is None:
            return w - lr * g, None
        mom = self.momentum * mom - lr * g
        return w + mom, mom


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, t = self._step(index)
        w = weight.data
        mean, var = state[0].data, state[1].data
        g = self._prep_grad(grad.data, w, wd)
        mean.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        var.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        step = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w.sub_(mean.mul(step).div_(var.sqrt().add_(self.epsilon)))

    def _state(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _rule(self, w, g, state, lr, wd, t):
        mean, var = state
        g = self._prep_grad(g, w, wd)
        mean = self.beta1 * mean + (1 - self.beta1) * g
        var = self.beta2 * var + (1 - self.beta2) * g.square()
        # float32 on the device when t is a tensor, as the JAX rule's
        step = lr * torch.sqrt(1 - self.beta2 ** torch.as_tensor(t)) \
            / (1 - self.beta1 ** torch.as_tensor(t))
        return w - step * mean / (var.sqrt() + self.epsilon), (mean, var)


@register
class ccSGD(SGD):  # noqa: N801 - the reference's spelling
    """Deprecated alias of SGD: SGD's update and rule."""


@register
class NAG(SGD):
    """Nesterov-accelerated SGD: ``mom = momentum * mom + g; w -= lr * (g
    + momentum * mom)``.  Its classic update is the base's run of this
    rule, not SGD's in-place math."""

    update = Optimizer.update

    def _rule(self, w, g, mom, lr, wd, t):
        g = self._prep_grad(g, w, wd)
        if mom is None:
            return w - lr * g, None
        mom = self.momentum * mom + g
        return w - lr * (g + self.momentum * mom), mom


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    ``sqrt(lr)`` Gaussian noise from the weight's device generator (the
    JAX package's threefry chain draws other numbers; ROADMAP §C).  No
    fused rule: Module trains it on the classic path."""

    has_noise = True

    def _rule(self, w, g, state, lr, wd, t, generator):
        g = self._prep_grad(g, w, wd)
        noise = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                            device=w.device)
        return w - 0.5 * lr * g + lr ** 0.5 * noise, state


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: the gradient corrected by a curvature
    term against the weight's snapshot from the last update.  The state
    is ``(momentum or None, snapshot)``; the snapshot is a tensor of its
    own (a clone), never the weight's storage, or a write of the new
    weight would move it too."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def _state(self, w):
        mom = torch.zeros_like(w) if self.momentum else None
        return (mom, w.clone())

    def _rule(self, w, g, state, lr, wd, t):
        mom, snapshot = state
        g = self._prep_grad(g, w, 0.0)
        comp = g + wd * w + self.lamda * g * g * (w - snapshot)
        if mom is None:
            step = -lr * comp
        else:
            mom = self.momentum * mom - lr * comp
            step = mom
        return w + step, (mom, w.clone())


@register
class AdaGrad(Optimizer):
    """AdaGrad; the weight decay applies outside the adaptive scaling, as
    the reference's does."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _state(self, w):
        return torch.zeros_like(w)

    def _rule(self, w, g, hist, lr, wd, t):
        g = self._prep_grad(g, w, 0.0)
        hist = hist + g.square()
        scaled = g * torch.rsqrt(hist + self.float_stable_eps)
        return w - lr * (scaled + wd * w), hist


@register
class RMSProp(Optimizer):
    """RMSProp: Tieleman's (state ``(n,)``) or, with ``centered``,
    Graves' (state ``(n, g-bar, delta)``); ``clip_weights > 0`` clips the
    new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def _state(self, w):
        n = 3 if self.centered else 1
        return tuple(torch.zeros_like(w) for _ in range(n))

    def _rule(self, w, g, state, lr, wd, t):
        g = self._prep_grad(g, w, wd)
        if not self.centered:
            (n,) = state
            n = (1 - self.gamma1) * g.square() + self.gamma1 * n
            w = w - lr * g / torch.sqrt(n + self.epsilon)
            state = (n,)
        else:
            n, gbar, delta = state
            n = (1 - self.gamma1) * g.square() + self.gamma1 * n
            gbar = (1 - self.gamma1) * g + self.gamma1 * gbar
            delta = self.gamma2 * delta - \
                lr * g * torch.rsqrt(n - gbar.square() + self.epsilon)
            w = w + delta
            state = (n, gbar, delta)
        if self.clip_weights is not None and self.clip_weights > 0:
            w = w.clamp(-self.clip_weights, self.clip_weights)
        return w, state


@register
class AdaDelta(Optimizer):
    """AdaDelta: unit-corrected steps from running averages of the
    squared gradient and the squared step."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def _state(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _rule(self, w, g, state, lr, wd, t):
        acc_g, acc_d = state
        g = self._prep_grad(g, w, 0.0)
        acc_g = self.rho * acc_g + (1 - self.rho) * g.square()
        step = torch.sqrt(acc_d + self.epsilon) * \
            torch.rsqrt(acc_g + self.epsilon) * g
        acc_d = self.rho * acc_d + (1 - self.rho) * step.square()
        return w - step - wd * w, (acc_g, acc_d)


@register
class Ftrl(Optimizer):
    """FTRL-proximal with L1 shrinkage ``lamda1``; state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def _state(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _rule(self, w, g, state, lr, wd, t):
        z, n = state
        g = self._prep_grad(g, w, 0.0)
        z = z + g - (torch.sqrt(n + g.square()) - torch.sqrt(n)) * w / lr
        n = n + g.square()
        shrunk = (torch.sign(z) * self.lamda1 - z) \
            / ((self.beta + torch.sqrt(n)) / lr + wd)
        w = torch.where(z.abs() > self.lamda1, shrunk, 0.0).to(w.dtype)
        return w, (z, n)


create = Optimizer.create_optimizer


@register
class Test(Optimizer):
    """The reference's deterministic test rule for the KVStore tests:
    ``w += rescale_grad * g``, the state mirroring the weight."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        weight.data.add_(grad.data * self.rescale_grad)
        state.data.copy_(weight.data)

    def _state(self, w):
        return torch.zeros_like(w)

    def _rule(self, w, g, state, lr, wd, t):
        w = w + self.rescale_grad * g
        return w, w


def _to_device(state, device):
    """A state with its arrays moved to ``device``."""
    return _map(lambda a: a if a.data.device == device
                else NDArray(a.data.to(device)), state)


def _is_state(state):
    """Whether ``state`` is made of the port's NDArrays (or None)."""
    return all(isinstance(a, NDArray) for a in _leaves(state))


class Updater(object):
    """Bridges the ``(index, grad, weight)`` callback onto an Optimizer,
    creating each index's state at its first update.  ``get_states``
    pickles the states on the host; ``set_states`` restores them, and
    each moves to its weight's device at its next update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        state = self.states[index] = _to_device(self.states[index],
                                                weight.data.device)
        self.optimizer.update(index, weight, grad, state)

    def set_states(self, blob):
        """Restore :meth:`get_states`' pickle.  A blob of another kind (the
        JAX package's, whose states are its own arrays) raises."""
        try:
            states = pickle.loads(blob)
        except Exception as e:                      # noqa: BLE001
            raise MXNetError("optimizer state blob is truncated or "
                             "corrupt: %s: %s" % (type(e).__name__, e)) \
                from e
        if not isinstance(states, dict) or not all(
                _is_state(v) for v in states.values()):
            raise MXNetError("optimizer state blob holds %s, not the "
                             "port's NDArray states (a JAX package's "
                             "states do not load here)"
                             % type(states).__name__)
        self.states = states

    def get_states(self):
        host = torch.device("cpu")
        return pickle.dumps({k: _to_device(v, host)
                             for k, v in self.states.items()})


def get_updater(optimizer):
    return Updater(optimizer)
