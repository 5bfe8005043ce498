"""Custom operators written in Python (``mxnet_tpu/operator.py``).

A ``Custom`` node is a :class:`torch.autograd.Function`: its forward
calls the user's :meth:`CustomOp.forward` with port NDArrays over the
node's own tensors, on the node's device (no host round trip of its
own: a body that calls ``asnumpy()`` makes one), and its backward calls
:meth:`CustomOp.backward` with the head gradients, the inputs and
outputs that :meth:`CustomOpProp.declare_backward_dependency` kept (the
others are ``None``), and gradient arrays to fill per ``req``
(``write`` where the input wants a gradient, ``null`` where it does
not; :meth:`CustomOp.assign` also honours ``add``).  Auxiliary states
reach both as NDArrays; what the forward writes into them is the
node's aux update.

A Python body cannot be captured in a CUDA graph.  Every Op made here
says so (``Op.python_body``), and :func:`uncapturable` names such nodes
of a graph, so the fused Trainer, the compiled forward of ``Predictor``
and ``ModelServer``, and ``Module.bind`` decide from the symbol, before
the first step or request, to run it eagerly and record why.
"""
from __future__ import annotations

import inspect
from typing import Dict

import torch

from .base import Context, MXNetError
from .ndarray import NDArray
from .op import registry as _reg
from .op.registry import Op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls",
           "PythonOp", "NumpyOp", "NDArrayOp", "NativeOp", "uncapturable"]

_CUSTOM_PROPS: Dict[str, type] = {}


class CustomOp(object):
    """Base class for custom operators (reference ``operator.py:408``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring the OpReqType
        (``write``/``inplace``, ``add``, ``null``)."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] += src


class CustomOpProp(object):
    """Operator-property for custom ops (reference ``operator.py:500``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


def register(reg_name):
    """Register a CustomOpProp class under ``op_type=reg_name``
    (reference ``operator.py:611``)."""

    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_prop_cls(op_type):
    if op_type not in _CUSTOM_PROPS:
        raise MXNetError("custom op type %s is not registered" % op_type)
    return _CUSTOM_PROPS[op_type]


def uncapturable(nodes):
    """Why a graph of ``nodes`` cannot be captured in a CUDA graph: the
    nodes whose body runs Python (a ``Custom`` or legacy op), named, or
    None where there is none."""
    py = ["%s (%s)" % (n.name, n.op.name) for n in nodes
          if not n.is_variable and n.op.python_body]
    return "Python bodies: %s" % ", ".join(py) if py else None


class _Runner:
    """One prop's operators, one per input signature, and the calls into
    them."""

    def __init__(self, prop):
        self.prop = prop
        self.n_in = len(prop.list_arguments())
        self.n_out = len(prop.list_outputs())
        self.n_aux = len(prop.list_auxiliary_states())
        # the ids the reference hands declare_backward_dependency: head
        # gradients, then inputs, then outputs
        og = list(range(self.n_out))
        ind = list(range(self.n_out, self.n_out + self.n_in))
        outd = list(range(self.n_out + self.n_in,
                          2 * self.n_out + self.n_in))
        deps = set(prop.declare_backward_dependency(og, ind, outd))
        self.keep_in = [i in deps for i in ind]
        self.keep_out = [i in deps for i in outd]
        self._ops = {}

    def op(self, ctx, signature):
        """The operator for inputs of ``signature`` (``(shape, dtype)``
        each), made at its first use."""
        op = self._ops.get((ctx, signature))
        if op is None:
            op = self._ops[(ctx, signature)] = self.prop.create_operator(
                ctx, [s for s, _ in signature], [d for _, d in signature])
        return op


class _CustomFunction(torch.autograd.Function):
    """A Custom node on torch autograd."""

    @staticmethod
    def forward(ctx, runner, is_train, *tensors):
        ins = tensors[:runner.n_in]
        device = ins[0].device
        dev_ctx = Context.from_torch_device(device)
        signature = tuple((tuple(t.shape), t.dtype) for t in ins)
        _, out_shapes, _ = runner.prop.infer_shape([s for s, _ in signature])
        outs = [torch.zeros(tuple(s), dtype=ins[0].dtype, device=device)
                for s in out_shapes]
        # the aux states the body writes: copies, handed back as the
        # node's aux updates
        aux = [a.clone() for a in tensors[runner.n_in:]]
        with dev_ctx:
            runner.op(dev_ctx, signature).forward(
                is_train=is_train, req=["write"] * runner.n_out,
                in_data=[NDArray(t, writable=False) for t in ins],
                out_data=[NDArray(t) for t in outs],
                aux=[NDArray(a) for a in aux])
        ctx.runner, ctx.dev_ctx, ctx.signature = runner, dev_ctx, signature
        ctx.out_meta = [(o.shape, o.dtype) for o in outs]
        ctx.save_for_backward(
            *[t for t, k in zip(ins, runner.keep_in) if k],
            *[t for t, k in zip(outs, runner.keep_out) if k], *aux)
        ctx.mark_non_differentiable(*aux)
        return tuple(outs) + tuple(aux)

    @staticmethod
    def backward(ctx, *grads):
        runner = ctx.runner
        saved = list(ctx.saved_tensors)

        def take(flags):
            return [NDArray(saved.pop(0), writable=False) if k else None
                    for k in flags]

        in_data = take(runner.keep_in)
        out_data = take(runner.keep_out)
        device = ctx.dev_ctx.torch_device()
        out_grad = [NDArray(g.contiguous() if g is not None else
                            torch.zeros(s, dtype=dt, device=device))
                    for g, (s, dt) in zip(grads, ctx.out_meta)]
        want = ctx.needs_input_grad[2:2 + runner.n_in]
        in_grad = [torch.zeros(s, dtype=dt, device=device)
                   for s, dt in ctx.signature]
        # the body may run torch autograd of its own (a bridged module)
        with ctx.dev_ctx, torch.enable_grad():
            runner.op(ctx.dev_ctx, ctx.signature).backward(
                req=["write" if w else "null" for w in want],
                out_grad=out_grad, in_data=in_data, out_data=out_data,
                in_grad=[NDArray(g) for g in in_grad],
                aux=[NDArray(a) for a in saved])
        return (None, None) + tuple(g if w else None
                                    for g, w in zip(in_grad, want)) \
            + (None,) * runner.n_aux


def _make_custom_fn(op_type, prop_kwargs):
    """The Op of a ``Custom`` node: the prop made from ``prop_kwargs``."""
    prop = get_prop_cls(op_type)(**prop_kwargs)
    return _make_custom_fn_from_prop(prop, "Custom[%s]" % op_type)


def _make_custom_fn_from_prop(prop, op_name):
    runner = _Runner(prop)

    def fn(params, ctx, *tensors):
        out = _CustomFunction.apply(runner, ctx.is_train, *tensors)
        return out if len(out) > 1 else out[0]

    return Op(name=op_name, fn=fn, params_spec=(),
              input_names=tuple(prop.list_arguments()),
              aux_names=tuple(prop.list_auxiliary_states()),
              num_outputs=runner.n_out, hint="custom",
              infer_shape=lambda p, in_shapes: prop.infer_shape(in_shapes),
              mode_dependent=True, python_body=True)


def _register_and_create(op, args, kwargs):
    """Register a freshly-built custom Op (a JSON round trip needs the
    registry row) and create its symbol node from Symbol inputs."""
    from .symbol import Symbol, _create
    bad = [a for a in args if not isinstance(a, Symbol)]
    if bad:
        raise MXNetError(
            "custom op inputs must be Symbols, got %s"
            % [type(a).__name__ for a in bad])
    _reg._REGISTRY[op.name] = op
    return _create(op.name, list(args), dict(kwargs))


# ----------------------------------------------------------------------
# Legacy foreign-function op classes (reference ``operator.py:19-257``:
# PythonOp -> NumpyOp / NDArrayOp), on the Custom machinery above.
class PythonOp(object):
    """Base: subclass, override ``forward``/``backward``/``infer_shape``/
    ``list_arguments``/``list_outputs``; calling the instance on input
    symbols yields the graph node (reference ``operator.py:19-118``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    # default behaviors: identity forward, all-ones backward, shape
    # passthrough, one data input -> one output
    def forward(self, in_data, out_data):
        out_data[0][:] = in_data[0]

    def backward(self, out_grad, in_data, out_data, in_grad):
        in_grad[0][:] = 1.0

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def need_top_grad(self):
        return self.need_top_grad_

    # NumpyOp presents numpy copies (flushed back after the call);
    # NDArrayOp presents the NDArrays themselves
    _use_numpy = False
    _node_kind = "_Python"
    _instances = 0

    def get_symbol(self, *args, **kwargs):
        legacy = self
        use_numpy = self._use_numpy

        def _views(nd_list):
            # writable host copies, which legacy ops mutate in place
            if not use_numpy:
                return list(nd_list)
            return [None if a is None else a.asnumpy() for a in nd_list]

        def _flush(nd_list, views):
            if use_numpy:
                for dst, v in zip(nd_list, views):
                    dst[:] = v

        class _Adapter(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                outs = _views(out_data)
                legacy.forward(in_data=_views(in_data), out_data=outs)
                _flush(out_data, outs)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                grads = _views(in_grad)
                legacy.backward(out_grad=_views(out_grad),
                                in_data=_views(in_data),
                                out_data=_views(out_data),
                                in_grad=grads)
                _flush(in_grad, grads)

        class _Prop(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=legacy.need_top_grad())

            def list_arguments(self):
                return legacy.list_arguments()

            def list_outputs(self):
                return legacy.list_outputs()

            def infer_shape(self, in_shape):
                shapes = legacy.infer_shape(in_shape)
                # legacy returns (in, out); modern adds aux
                return (shapes if len(shapes) == 3
                        else (shapes[0], shapes[1], []))

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return _Adapter()

        # built and registered once per INSTANCE (a unique suffix: two
        # differently-configured instances of one subclass must not
        # overwrite each other's row; re-calls on one instance reuse it)
        if getattr(self, "_op", None) is None:
            PythonOp._instances += 1
            self._op = _make_custom_fn_from_prop(
                _Prop(), "%s[%s:%d]" % (self._node_kind,
                                        type(self).__name__,
                                        PythonOp._instances))
        return _register_and_create(self._op, args, kwargs)


class NumpyOp(PythonOp):
    """Forward/backward see numpy arrays; mutate ``out_data[i][:]``
    in place (reference ``operator.py:120-225``, the ``_Native`` op)."""

    _node_kind = "_Native"
    _use_numpy = True


class NDArrayOp(PythonOp):
    """Forward/backward see NDArrays directly (reference
    ``operator.py:226-257``, the ``_NDArray`` op)."""

    _node_kind = "_NDArray"


# alias kept for scripts that imported the C-callback flavor by name
NativeOp = NumpyOp


def _custom_entry(namespace):
    """Front-end ``Custom(..., op_type=...)`` for the nd/sym namespaces."""

    def Custom(*args, **kwargs):
        op_type = kwargs.pop("op_type", None)
        if op_type is None:
            raise MXNetError("Custom requires op_type=")
        name = kwargs.pop("name", None)
        prop_cls = get_prop_cls(op_type)
        sig = set(inspect.signature(prop_cls.__init__).parameters) - {"self"}
        prop_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                       if k in sig or k == "need_top_grad"}
        op = _make_custom_fn(op_type, prop_kwargs)
        if namespace == "sym":
            if name is not None:
                kwargs["name"] = name
            return _register_and_create(op, args, kwargs)
        from .op.invoke import invoke
        arrays = [a for a in args if isinstance(a, NDArray)]
        res = invoke(op, arrays, kwargs)
        return res[0] if len(res) == 1 else res

    return Custom
