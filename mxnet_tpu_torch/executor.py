"""Graph executor (``mxnet_tpu/executor.py``).

The JAX package traces the graph walk into one jitted XLA program and
differentiates it with ``jax.vjp``; here the walk runs eagerly, each
node's op body launching its kernels as it goes, and a training forward
records the walk on torch autograd: the arguments that want a gradient
become leaf tensors, and ``backward`` asks autograd for their gradients
(``torch.autograd.grad``), through the ops' own backward formulas and
the injected gradients of the loss layers.  There is no jit and no
program cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, current_context, dtype_name
from .ndarray import NDArray, zeros
from .op.registry import OpContext
from .symbol import Symbol, _topo

__all__ = ["Executor", "bind", "simple_bind"]


class _GraphProgram:
    """A Symbol's nodes in evaluation order, plus its argument metadata."""

    def __init__(self, sym: Symbol):
        self.sym = sym
        self.nodes = _topo([e[0] for e in sym._outputs])
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()
        self.output_entries = list(sym._outputs)
        self._arg_index = {n: i for i, n in enumerate(self.arg_names)}
        self._aux_index = {n: i for i, n in enumerate(self.aux_names)}
        # the walk drops each value after its last reader (the graph's
        # outputs excepted), so an inference forward holds a few layers'
        # activations at a time, not all of them (autograd keeps what a
        # training backward needs by itself)
        self._kept = {(id(nd), i) for nd, i in self.output_entries}
        last = {}
        for pos, n in enumerate(self.nodes):
            for c, i in n.inputs:
                last[(id(c), i)] = pos
        self._read = set(last)
        self._release = [[] for _ in self.nodes]
        for key, pos in last.items():
            if key not in self._kept:
                self._release[pos].append(key)
        # the backward formulations' policy (op/bytediet.py); None
        # takes the process default
        self.dtype_policy = None

    def _context(self, device, is_train, rng, record=None, batch_sum=None,
                 batch_ranks=1):
        return OpContext(is_train=is_train, device=device,
                         rng=_random.generator(device) if rng is None
                         else rng, record=record,
                         dtype_policy=self.dtype_policy,
                         batch_sum=batch_sum, batch_ranks=batch_ranks)

    def _eval_node(self, n, ctx, env, aux_vals, aux_out, monitor=None):
        """Run the op node ``n`` on its inputs in ``env``: its outputs go
        into ``env`` (those read later or kept), its aux updates into
        ``aux_out``."""
        in_vals = [env[(id(c), i)] for c, i in n.inputs]
        slots = [self._aux_index["%s_%s" % (n.name, a)]
                 for a in n.aux_names()]
        node_aux = [aux_vals[s].detach() for s in slots]
        outs, aux_updates = n.op.apply(n.params, ctx, *(in_vals + node_aux))
        for i, v in enumerate(outs):
            key = (id(n), i)
            if key in self._read or key in self._kept:
                env[key] = v
            if monitor is not None:
                monitor("%s_%s" % (n.name, n.op.list_outputs(n.params)[i]),
                        NDArray(v.detach()))
        for s, v in zip(slots, aux_updates):
            aux_out[s] = v.detach()

    def _eval(self, arg_vals: Sequence[torch.Tensor],
              aux_vals: Sequence[torch.Tensor], device: torch.device,
              is_train=False, rng: Optional[torch.Generator] = None,
              monitor=None, batch_sum=None, batch_ranks=1):
        """Evaluate the graph; returns ``(outputs, aux_states)``, the aux
        states as the ops updated them.  ``device`` is where ops without
        tensor inputs create theirs; samplers draw from ``rng``, by
        default the device's generator (``random.generator``).  In
        training, op bodies run under torch autograd wherever an input
        requires a gradient.  ``monitor(name, NDArray)`` sees every
        output of every op node, named ``"<node>_<output>"`` as in the
        JAX package, before the walk releases it; it gets the value off
        the autograd graph.  ``batch_sum``/``batch_ranks``: the batch's
        rows lie on that many ranks (``OpContext``)."""
        ctx = self._context(device, is_train, rng, batch_sum=batch_sum,
                            batch_ranks=batch_ranks)
        env = {}
        aux_out = list(aux_vals)
        for pos, n in enumerate(self.nodes):
            if n.is_variable:
                env[(id(n), 0)] = arg_vals[self._arg_index[n.name]]
                continue
            self._eval_node(n, ctx, env, aux_vals, aux_out, monitor)
            for key in self._release[pos]:
                del env[key]
        outputs = tuple(env[(id(nd), i)] for nd, i in self.output_entries)
        return outputs, tuple(aux_out)


def _normalize_grad_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    raise MXNetError("invalid grad_req %r" % (grad_req,))


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    if isinstance(value, NDArray):
        value = value.data
    elif not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device=like.device, dtype=like.dtype)


class Executor:
    """Bound executor (reference ``include/mxnet/executor.h:34-102``):
    NDArrays for every argument, gradient and aux state of a symbol, a
    forward that fills ``outputs``, and a backward that fills the
    gradient arrays per ``grad_req`` (``write``, ``add`` or ``null``)."""

    def __init__(self, sym: Symbol, ctx, args: Dict[str, NDArray],
                 args_grad: Optional[Dict[str, NDArray]], grad_req,
                 aux_states: Dict[str, NDArray]):
        self._symbol = sym
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        self._prog = _GraphProgram(sym)
        self.arg_dict = args
        self.grad_dict = args_grad or {}
        self.aux_dict = aux_states
        self.arg_arrays = [args[n] for n in self._prog.arg_names]
        self.grad_arrays = [self.grad_dict.get(n)
                            for n in self._prog.arg_names]
        self.aux_arrays = [aux_states[n] for n in self._prog.aux_names]
        self.grad_req = _normalize_grad_req(grad_req, self._prog.arg_names)
        self._outputs: List[NDArray] = []
        # the last training forward: its outputs, still on the autograd
        # graph, and the leaf tensors that stand for the arguments
        self._graph = None
        self._monitor = None
        # partial_forward's walk: (env, aux states, context, next step),
        # and whether a walk ran to its end
        self._partial = None
        self._partial_done = False

    @property
    def outputs(self):
        return self._outputs

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self._outputs))

    def _wants_grad(self, name):
        return self.grad_req.get(name, "null") != "null" \
            and self.grad_dict.get(name) is not None

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` write new argument values first.  A
        training forward keeps the autograd graph for :meth:`backward`."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %s" % k)
            dst = self.arg_dict[k]
            dst._set_data(_as_tensor(v, dst.data))
        leaves = {}
        arg_vals = []
        for name, arr in zip(self._prog.arg_names, self.arg_arrays):
            val = arr.data
            if is_train and self._wants_grad(name):
                val = leaves[name] = val.detach().requires_grad_()
            arg_vals.append(val)
        outs, new_aux = self._prog._eval(
            arg_vals, [a.data for a in self.aux_arrays], self._device,
            is_train=is_train, monitor=self._monitor)
        for arr, v in zip(self.aux_arrays, new_aux):
            if v is not arr.data:
                arr._set_data(v)
        self._graph = (outs, leaves) if is_train else None
        self._outputs = [NDArray(o.detach()) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into the gradient
        arrays.  A missing head gradient is ones, as in the reference;
        loss layers inject their own and ignore it."""
        if self._graph is None:
            raise MXNetError("run forward(is_train=True) before backward")
        outs, leaves = self._graph
        self._graph = None
        if out_grads is None:
            out_grads = []
        elif not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        heads, cotangents = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            g = out_grads[i] if i < len(out_grads) else None
            heads.append(o)
            cotangents.append(torch.ones_like(o) if g is None
                              else _as_tensor(g, o))
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        cotangents, allow_unused=True)
        for name, g in zip(names, grads):
            buf = self.grad_dict[name]
            if g is None:
                g = torch.zeros_like(buf.data)
            if self.grad_req[name] == "add":
                buf._set_data(buf.data + g)
            else:
                buf._set_data(g)

    def partial_forward(self, is_train=False, step=0):
        """Run exactly op node ``step`` of the forward (the nodes in
        evaluation order, variables not counted); returns the number of
        nodes left.  Call with ``step`` 0, 1, ... until it returns 0, as
        the reference's ``PartialForward``; the outputs and aux states
        are published after the last node.  A debugging surface: nothing
        is recorded for a backward, and a step out of order raises."""
        prog = self._prog
        compute = [(pos, n) for pos, n in enumerate(prog.nodes)
                   if not n.is_variable]
        if step >= len(compute):
            # "done" answers only right after a walk ran to its end; a
            # cold or mid-walk step past the end is out of order
            if not compute or (step > 0 and self._partial is None
                               and self._partial_done):
                return 0
            raise MXNetError(
                "partial_forward steps must be issued in order from 0 "
                "(expected step %d, got %d)"
                % (self._partial[3] if self._partial else 0, step))
        if step == 0:
            self._partial_done = False
            env = {(id(n), 0): self.arg_dict[n.name].data
                   for n in prog.nodes if n.is_variable}
            self._partial = (env, [a.data for a in self.aux_arrays],
                             prog._context(self._device, is_train, None,
                                           record=False), 0)
        if self._partial is None or self._partial[3] != step:
            raise MXNetError(
                "partial_forward steps must be issued in order from 0 "
                "(expected step %s, got %d)"
                % (self._partial[3] if self._partial else 0, step))
        env, aux_out, ctx, _ = self._partial
        pos, node = compute[step]
        with torch.no_grad():
            prog._eval_node(node, ctx, env, [a.data for a in
                                             self.aux_arrays], aux_out)
        for key in prog._release[pos]:
            del env[key]
        left = len(compute) - step - 1
        if left:
            self._partial = (env, aux_out, ctx, step + 1)
            return left
        for arr, v in zip(self.aux_arrays, aux_out):
            if v is not arr.data:
                arr._set_data(v)
        self._outputs = [NDArray(env[(id(nd), i)])
                         for nd, i in prog.output_entries]
        self._partial = None
        self._partial_done = True
        self._graph = None      # no backward for these outputs
        return 0

    def debug_str(self):
        """The graph as the JAX package prints it: the outputs, then a
        line a node in evaluation order with the dtype and shape of each
        of its outputs at the bound shapes."""
        internals = self._symbol.get_internals()
        try:
            _, shapes, _ = internals.infer_shape(
                **{n: tuple(a.shape) for n, a in self.arg_dict.items()})
            _, dtypes, _ = internals.infer_type(
                **{n: a.dtype for n, a in self.arg_dict.items()})
        except MXNetError:
            shapes = dtypes = None
        lines = ["Symbol outputs: %s"
                 % ", ".join(self._symbol.list_outputs())]
        k = 0
        for n in self._prog.nodes:
            outs = []
            for _ in range(n.num_outputs()):
                s = shapes[k] if shapes else None
                t = dtypes[k] if dtypes else None
                outs.append("%s %s" % (dtype_name(t) if t is not None
                                       else "?", s if s is not None else "?"))
                k += 1
            sd = ", out=[%s]" % "; ".join(outs)
            if n.is_variable:
                lines.append("Variable:%s%s" % (n.name, sd))
            else:
                lines.append("Op:%s, Name=%s%s" % (n.op.name, n.name, sd))
        return "\n".join(lines)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes (reference
        ``executor.py:380-401``): arrays whose shape stays are this
        executor's own, the others are new zeros, and so are all the
        gradients."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % kwargs)

        def keep_or_new(old, shape):
            if tuple(old.shape) == tuple(shape):
                return old
            return zeros(shape, self._ctx, old.dtype)

        new_args = {n: keep_or_new(self.arg_dict[n], s)
                    for n, s in zip(self._prog.arg_names, arg_shapes)}
        new_aux = {n: keep_or_new(self.aux_dict[n], s)
                   for n, s in zip(self._prog.aux_names, aux_shapes)}
        grads = None
        if self.grad_dict:
            grads = {n: zeros(new_args[n].shape, self._ctx,
                              new_args[n].dtype) for n in self.grad_dict}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self.grad_req, new_aux)

    def install_monitor(self, callback):
        """Tap every op output of later forwards (reference
        ``graph_executor.cc:757-778``): ``callback(name, NDArray)``."""
        self._monitor = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound arrays (their device and
        dtype stay)."""
        for params, bound, what in ((arg_params, self.arg_dict, "argument"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux state")):
            for name, arr in params.items():
                if name in bound:
                    dst = bound[name]
                    dst._set_data(_as_tensor(arr, dst.data))
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %s" % (what, name))


def _to_dict(arrays, names, what, allow_partial=False):
    if isinstance(arrays, dict):
        missing = [n for n in names if n not in arrays]
        if missing and not allow_partial:
            raise MXNetError("%s missing entries for %s" % (what, missing))
        return {n: arrays[n] for n in names if n in arrays}
    arrays = list(arrays)
    if len(arrays) != len(names):
        raise MXNetError("%s length %d != expected %d (%s)"
                         % (what, len(arrays), len(names), names))
    return dict(zip(names, arrays))


def _check_group2ctx(group2ctx, ctx):
    """A ``group2ctx`` map is taken where every context it names is the
    bound one: everything runs there.  Placing groups on other devices
    comes with the multi-device slice."""
    for group, where in (group2ctx or {}).items():
        if where != ctx:
            raise MXNetError(
                "group2ctx places group %r on %s, not on the bound %s: "
                "placement across devices is not ported yet (ROADMAP "
                "item 5)" % (group, where, ctx))


def bind(sym, ctx, args, args_grad=None, grad_req="write", aux_states=None,
         group2ctx=None):
    """Bind given arrays (reference ``executor.py:489``)."""
    ctx = ctx or current_context()
    _check_group2ctx(group2ctx, ctx)
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    args = _to_dict(args, arg_names, "args")
    if args_grad is not None:
        args_grad = _to_dict(args_grad, arg_names, "args_grad",
                             allow_partial=True)
    aux_states = _to_dict(aux_states or {}, aux_names, "aux_states")
    return Executor(sym, ctx, args, args_grad, grad_req, aux_states)


def simple_bind(sym, ctx=None, grad_req="write", type_dict=None,
                shared_exec=None, group2ctx=None, **kwargs):
    """Infer every shape and dtype from the given input shapes and bind
    zero-filled arrays, gradients for each argument whose ``grad_req`` is
    not ``null`` (reference ``executor.py:504-545``).

    With ``shared_exec`` (a bucket binding against another bucket's
    executor, as the reference's ``simple_bind`` does) every argument,
    gradient and aux state whose name, shape and dtype match one of
    ``shared_exec``'s is that very NDArray, so both executors read and
    write one memory; only what differs (the inputs and gradients of
    another length) is allocated."""
    ctx = ctx or current_context()
    _check_group2ctx(group2ctx, ctx)
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    arg_shapes, _, aux_shapes = sym.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError("cannot infer shapes from %s" % kwargs)
    arg_types, _, aux_types = sym.infer_type(**(type_dict or {}))

    def alloc(shared, names, shapes, types, keep=lambda n: True):
        out = {}
        for n, s, t in zip(names, shapes, types):
            if not keep(n):
                continue
            arr = shared.get(n)
            if arr is None or arr.shape != tuple(s) or arr.dtype != t:
                arr = zeros(s, ctx, t)
            out[n] = arr
        return out

    if shared_exec is not None and shared_exec._ctx != ctx:
        raise MXNetError("shared_exec is bound on %s, not on %s"
                         % (shared_exec._ctx, ctx))
    reqs = _normalize_grad_req(grad_req, arg_names)
    args = alloc(shared_exec.arg_dict if shared_exec else {}, arg_names,
                 arg_shapes, arg_types)
    args_grad = alloc(shared_exec.grad_dict if shared_exec else {},
                      arg_names, arg_shapes, arg_types,
                      lambda n: reqs[n] != "null")
    aux_states = alloc(shared_exec.aux_dict if shared_exec else {},
                       aux_names, aux_shapes, aux_types)
    return Executor(sym, ctx, args, args_grad, grad_req, aux_states)
