"""Imperative op invocation (``mxnet_tpu/op/invoke.py``), the analog of
the reference's ``MXImperativeInvoke`` (``src/c_api/c_api_ndarray.cc:
324-390``).

Each call runs the op body eagerly on the NDArrays' tensors, on the
device they lie on; torch's stream ordering stands in for the
reference's dependency engine.  Inside ``autograd.record()`` the body
runs under torch autograd, which is the port's tape
(``mxnet_tpu_torch/autograd.py``); ``autograd.is_training()`` selects
the ops' training behaviour.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..base import Context, current_context
from .registry import Op, OpContext


def invoke(op: Op, inputs: List["NDArray"], kwargs: Dict, out=None,
           aux_states: Optional[List["NDArray"]] = None):
    """Apply ``op`` eagerly to NDArray inputs.  Returns a list of
    NDArrays.  An op without inputs runs on its ``ctx`` param's device,
    else on the current context's."""
    from .. import autograd, random as _random
    from ..ndarray import NDArray, _shares_memory

    params = op.parse_params(kwargs)
    aux_states = aux_states or []
    in_vals = [a.data for a in inputs] + [a.data for a in aux_states]
    if in_vals:
        device = in_vals[0].device
    else:
        ctx = params.get("ctx")
        device = (Context.parse(ctx) if ctx else current_context()) \
            .torch_device()
    rng = _random.generator(device) if op.uses_rng else None
    outs, aux_updates = op.apply(
        params, OpContext(is_train=autograd.is_training(), device=device,
                          rng=rng, record=autograd.is_recording()),
        *in_vals)

    if out is not None:
        out_nd = [out] if isinstance(out, NDArray) else list(out)
        for o, v in zip(out_nd, outs):
            o._set_data(v)
    else:
        # an op body may return a view of its input (Reshape, slice_axis,
        # identity); a new NDArray owns its memory, as the reference's do
        out_nd = [NDArray(v.clone() if any(_shares_memory(v, t)
                                           for t in in_vals) else v)
                  for v in outs]

    for a, v in zip(aux_states, aux_updates):
        a._set_data(v)
    return out_nd


def make_ndarray_function(op: Op):
    """Build the generated ``mx.nd.<op>`` front-end."""
    from ..ndarray import NDArray

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)  # accepted for API parity, unused
        arrays = [a for a in args if isinstance(a, NDArray)]
        if len(arrays) != len(args):
            raise TypeError(
                "%s: positional args must be NDArrays, use kwargs for params"
                % op.name)
        # pull named inputs/aux out of kwargs
        named_arrays = {k: v for k, v in kwargs.items()
                        if isinstance(v, NDArray)}
        for k in named_arrays:
            kwargs.pop(k)
        params = op.parse_params(kwargs)
        ins = []
        it = iter(arrays)
        for nm in op.list_inputs(params):
            if nm in named_arrays:
                ins.append(named_arrays.pop(nm))
            else:
                try:
                    ins.append(next(it))
                except StopIteration:
                    raise TypeError("%s missing input %r" % (op.name, nm))
        aux = [named_arrays.pop(nm) for nm in op.list_aux(params)
               if nm in named_arrays]
        if list(it) or named_arrays:
            raise TypeError("%s got extra array arguments" % op.name)
        res = invoke(op, ins, kwargs, out=out, aux_states=aux)
        if out is not None:
            return out
        return res[0] if len(res) == 1 else res

    fn.__name__ = op.name
    fn.__doc__ = "Imperative op %s (auto-generated)" % op.name
    return fn
