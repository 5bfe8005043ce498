"""Symbolic graph API (``mxnet_tpu/symbol.py``).

A Symbol is a DAG of op nodes.  Shape/type inference walk the graph
calling each op's inference hook (default: the op body on meta
tensors).  ``tojson``/``load_json`` write and read the same JSON as the
JAX package, so one ``-symbol.json`` file loads in both.
"""
from __future__ import annotations

import ast
import json
from numbers import Number
from typing import Any, Dict, List, Sequence, Tuple

import torch

from . import attribute
from . import name as _name_mgr
from . import op as _op  # noqa: F401  (populates the registry)
from .base import MXNetError, _dtype, dtype_name
from .op import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "params", "attrs", "inputs")

    def __init__(self, op, name, params=None, attrs=None, inputs=None):
        self.op = op            # Op or None for variables
        self.name = name
        self.params = params or {}
        self.attrs = attrs or {}
        self.inputs = inputs or []  # list[(node, out_index)]

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_variable else self.op.n_outputs(self.params)

    def aux_names(self):
        return [] if self.is_variable else self.op.list_aux(self.params)


def _topo(nodes_out: Sequence[_Node]) -> List[_Node]:
    # iterative post-order: graph depth must not be bounded by the
    # Python recursion limit.  A node re-encountered while still gray
    # (expanded but not emitted) is reachable from its own descendants.
    seen = set()
    gray = {}            # id -> node, expanded but not yet emitted
    order = []
    stack = [(n, False) for n in reversed(nodes_out)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            gray.pop(id(node), None)
            continue
        if id(node) in seen:
            if id(node) in gray:
                raise MXNetError(
                    "cycle detected in symbol graph at node %r; nodes on "
                    "the cycle path: %s"
                    % (node.name, sorted(g.name for g in gray.values())[:8]))
            continue
        seen.add(id(node))
        gray[id(node)] = node
        stack.append((node, True))
        for child, _ in reversed(node.inputs):
            stack.append((child, False))
    return order


class Symbol:
    """Symbolic multi-output expression (a list of graph output entries)."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group")

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        return Symbol([self._outputs[index]])

    def __copy__(self):
        """A new Symbol over the same nodes."""
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        """A new graph, through the JSON."""
        return load_json(self.tojson())

    # arithmetic ---------------------------------------------------------
    def __add__(self, other):
        return _sym_ufunc(self, other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_ufunc(self, other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_ufunc(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _sym_ufunc(self, other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_ufunc(self, other, "_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _sym_ufunc(self, other, None, "_rdiv_scalar")

    def __neg__(self):
        return _sym_ufunc(self, -1.0, None, "_mul_scalar")

    def __pow__(self, other):
        return _sym_ufunc(self, other, "_power", "_power_scalar")

    # no __eq__/__ne__: like the reference Symbol, equality is identity
    # (symbolic equality is sym.broadcast_equal); the orderings compare
    def __gt__(self, other):
        return _sym_ufunc(self, other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return _sym_ufunc(self, other, "_greater_equal",
                          "_greater_equal_scalar")

    def __lt__(self, other):
        return _sym_ufunc(self, other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _sym_ufunc(self, other, "_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    def list_arguments(self) -> List[str]:
        return [n.name for n in _topo([e[0] for e in self._outputs])
                if n.is_variable]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                names.append("%s_%s" % (node.name,
                                        node.op.list_outputs(node.params)[idx]))
        return names

    def list_auxiliary_states(self) -> List[str]:
        names = []
        for n in _topo([e[0] for e in self._outputs]):
            if not n.is_variable:
                names.extend("%s_%s" % (n.name, a) for a in n.aux_names())
        return names

    def list_inputs(self) -> List[str]:
        """The arguments, then the auxiliary states."""
        return self.list_arguments() + self.list_auxiliary_states()

    def attr(self, key):
        """The attribute ``key`` of a single-output symbol's node, else
        None."""
        if len(self._outputs) == 1:
            return self._outputs[0][0].attrs.get(key)
        return None

    def _set_attr(self, **kwargs):
        """Set attributes on the outputs' nodes."""
        for node, _ in self._outputs:
            node.attrs.update(kwargs)

    def attr_dict(self):
        """Every node's attributes and params as strings, by node name
        (the ``__lr_mult__``/``__init__`` a Variable carries included)."""
        ret = {}
        for n in _topo([e[0] for e in self._outputs]):
            d = dict(n.attrs)
            d.update({k: _attr_str(v) for k, v in n.params.items()
                      if v is not None})
            if d:
                ret[n.name] = d
        return ret

    # ------------------------------------------------------------------
    # binding (reference symbol.py bind / simple_bind)
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import bind
        return bind(self, ctx, args, args_grad, grad_req, aux_states,
                    group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        from .executor import simple_bind
        return simple_bind(self, ctx, grad_req, type_dict,
                           shared_exec=shared_exec, group2ctx=group2ctx,
                           **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` as the arguments and run an inference
        forward; returns the outputs."""
        return self.bind(ctx, kwargs).forward()

    def grad(self, wrt):
        raise MXNetError("Symbol.grad is deprecated; use bind + backward")

    def get_internals(self) -> "Symbol":
        outs = []
        for n in _topo([e[0] for e in self._outputs]):
            for i in range(n.num_outputs()):
                outs.append((n, i))
        return Symbol(outs)

    def get_children(self):
        """The inputs of the outputs' nodes as one Symbol, or None for a
        variable."""
        outs = []
        for node, _ in self._outputs:
            outs.extend(node.inputs)
        return Symbol(outs) if outs else None

    # ------------------------------------------------------------------
    # shape / type inference
    def infer_shape(self, *args, **kwargs):
        arg_s, out_s, aux_s = self._infer_shape_impl(False, *args, **kwargs)
        if arg_s is not None and any(s is None for s in arg_s):
            return None, None, None
        return arg_s, out_s, aux_s

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        shapes, out_shapes, aux_shapes = _infer_graph(
            self, known, partial=partial, what="shape")
        return [shapes.get(n) for n in arg_names], out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Dtypes (``torch.dtype``) of arguments, outputs and aux states;
        known dtypes may be given as torch or numpy dtypes or names."""
        arg_names = self.list_arguments()
        known: Dict[str, Any] = {}
        for name, dt in zip(arg_names, args):
            if dt is not None:
                known[name] = _dtype(dt)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = _dtype(v)
        types, out_types, aux_types = _infer_graph(
            self, known, partial=False, what="type")
        return [types.get(n) for n in arg_names], out_types, aux_types

    # ------------------------------------------------------------------
    # serialization
    def tojson(self):
        nodes = _topo([e[0] for e in self._outputs])
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(c)], i, 0] for c, i in n.inputs],
            }
            attrs = {k: _attr_str(v) for k, v in n.params.items()
                     if v is not None}
            attrs.update(n.attrs)
            if attrs:
                entry["attrs"] = attrs
            jnodes.append(entry)
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[nid[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_version": ["int", 905]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _attr_str(v):
    if isinstance(v, torch.dtype):
        return dtype_name(v)
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


def _sym_ufunc(lhs, rhs, array_op, scalar_op):
    if isinstance(rhs, Symbol):
        if array_op is None:
            raise MXNetError("unsupported Symbol operation")
        return _create(array_op, [lhs, rhs], {})
    if isinstance(rhs, Number):
        return _create(scalar_op, [lhs], {"scalar": float(rhs)})
    raise TypeError("type %s not supported" % str(type(rhs)))


# ----------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None) -> Symbol:
    """Create a symbolic variable (reference ``symbol.py`` Variable):
    ``lr_mult``/``wd_mult`` scale the optimizer's rates for it, ``init``
    (an initializer or its ``dumps()``) overrides the default rule."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = attribute.current().get(attr)
    node = _Node(None, name, attrs=dict(attr or {}))
    if shape is not None:
        node.attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        node.attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node.attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        node.attrs["__dtype__"] = dtype_name(_dtype(dtype))
    if init is not None:
        node.attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    return Symbol([(node, 0)])


var = Variable


def Group(symbols) -> Symbol:
    """One symbol whose outputs are those of ``symbols``, in order (an
    RNN's per-step outputs and final states, for instance)."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str) -> Symbol:
    """Rebuild a Symbol from JSON (accepts the JAX package's output and
    reference-style nnvm JSON with per-node "attr"/"attrs"/"param")."""
    data = json.loads(json_str)
    jnodes = data["nodes"]
    nodes: List[_Node] = []
    for jn in jnodes:
        attrs = dict(jn.get("attrs") or jn.get("attr") or jn.get("param") or {})
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attrs=attrs)
        else:
            op = _reg.get(jn["op"])
            spec = {p.name for p in op.params_spec}
            params = op.parse_params(
                {k: v for k, v in attrs.items() if k in spec})
            node = _Node(op, jn["name"], params=params,
                         attrs={k: v for k, v in attrs.items()
                                if k not in spec})
        nodes.append(node)
    for jn, node in zip(jnodes, nodes):
        node.inputs = [(nodes[i[0]], i[1]) for i in jn["inputs"]
                       if not _is_aux_input(nodes[i[0]], node)]
    return Symbol([(nodes[h[0]], h[1]) for h in data["heads"]])


def _is_aux_input(child: _Node, parent: _Node) -> bool:
    """Reference JSON lists aux states (moving_mean...) as inputs; they
    are tracked per node here, so those edges drop on load."""
    if parent.is_variable or not child.is_variable:
        return False
    aux = parent.aux_names()
    return any(child.name.endswith("_" + a) or child.name == a for a in aux)


# ----------------------------------------------------------------------
# op front-end creation
def _create(op_name, sym_args, kwargs) -> Symbol:
    op = _reg.get(op_name)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    for k in sym_kwargs:
        kwargs.pop(k)
    # a variadic op (Concat) counts its inputs, as the reference does
    if "num_args" in {p.name for p in op.params_spec} \
            and "num_args" not in kwargs:
        kwargs["num_args"] = len(sym_args) + len(sym_kwargs)
    params = op.parse_params(kwargs)
    name = _name_mgr.current().get(name, op.hint)
    attrs = attribute.current().get(attr)

    inputs: List[Tuple[_Node, int]] = []
    it = iter(sym_args)
    for in_name in op.list_inputs(params):
        if in_name in sym_kwargs:
            s = sym_kwargs.pop(in_name)
        else:
            s = next(it, None)
            if s is None:
                s = Variable("%s_%s" % (name, in_name))
        if len(s._outputs) != 1:
            raise MXNetError("cannot compose multi-output symbol as input")
        inputs.append(s._outputs[0])
    if sym_kwargs:
        raise MXNetError("%s got unknown symbol inputs %s"
                         % (op_name, list(sym_kwargs)))
    node = _Node(op, name, params=params, attrs=dict(attrs or {}),
                 inputs=inputs)
    return Symbol([(node, i) for i in range(op.n_outputs(params))])


def make_symbol_function(op: _reg.Op):
    def fn(*args, **kwargs):
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError("%s: positional args must be Symbols" % op.name)
        return _create(op.name, list(args), kwargs)

    fn.__name__ = op.name
    fn.__doc__ = "Symbolic op %s (auto-generated)" % op.name
    return fn


# ----------------------------------------------------------------------
# graph-wide inference engine
def _infer_graph(sym: Symbol, known: Dict[str, Any], partial: bool, what: str):
    """Walk the graph topologically, inferring shapes or dtypes (the
    reference's InferShape/InferType passes, ``graph_executor.cc:425-426``)."""
    nodes = _topo([e[0] for e in sym._outputs])
    results: Dict[Tuple[int, int], Any] = {}  # (node_id, out_idx) -> val
    var_vals: Dict[str, Any] = dict(known)
    aux_vals: Dict[str, Any] = {}

    for n in nodes:
        if n.is_variable:
            val = var_vals.get(n.name)
            if val is None and what == "shape" and "__shape__" in n.attrs:
                val = tuple(ast.literal_eval(n.attrs["__shape__"]))
                var_vals[n.name] = val
            if val is None and what == "type" and n.attrs.get("__dtype__"):
                val = _dtype(n.attrs["__dtype__"])
                var_vals[n.name] = val
            results[(id(n), 0)] = val
            continue
        in_vals = [results.get((id(c), i)) for c, i in n.inputs]
        try:
            if what == "shape":
                in_s, out_s, aux_s = n.op.infer_shape_generic(n.params, in_vals)
            else:
                in_s, out_s, aux_s = n.op.infer_dtype_generic(n.params, in_vals)
        except Exception as e:  # noqa: BLE001  (any op body may raise here)
            if partial:
                for i in range(n.num_outputs()):
                    results[(id(n), i)] = None
                continue
            raise MXNetError(
                "%s inference failed at node %s(%s): %s"
                % (what, n.name, n.op.name, e)) from e
        # write back refined input shapes into variable nodes
        for (c, _), new_v in zip(n.inputs, in_s):
            if c.is_variable and new_v is not None:
                prev = var_vals.get(c.name)
                if what == "shape" and prev is not None \
                        and tuple(prev) != tuple(new_v):
                    raise MXNetError(
                        "shape mismatch for %s: %s vs %s" % (c.name, prev, new_v))
                var_vals[c.name] = tuple(new_v) if what == "shape" else new_v
                results[(id(c), 0)] = var_vals[c.name]
        for i, v in enumerate(out_s):
            results[(id(n), i)] = tuple(v) if what == "shape" and v is not None else v
        for a_name, v in zip(n.aux_names(), aux_s):
            aux_vals["%s_%s" % (n.name, a_name)] = v

    out_vals = [results.get((id(nd), i)) for nd, i in sym._outputs]
    aux_names = sym.list_auxiliary_states()
    return var_vals, out_vals, [aux_vals.get(a) for a in aux_names]


def __getattr__(name):
    """Ops resolve from the registry: ``sym.FullyConnected(...)``."""
    try:
        op = _reg.get(name)
    except MXNetError:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name)) from None
    fn = make_symbol_function(op)
    globals()[name] = fn
    return fn
