"""The fused train step (``mxnet_tpu/parallel/trainer.py``): forward,
backward and optimizer update as one step, on one device.

The JAX package jits the whole step into one XLA program.  Here the
step is one Python function over torch tensors: the graph walk recorded
on torch autograd, ``torch.autograd.grad`` for the float32 gradients,
the optional finiteness sentinel, and the optimizer's pure rule over
every parameter, whose results are written into the trainer's state
tensors in place.  On a CUDA device the first step with a given set of
batch shapes runs eagerly on a side stream (it builds the kernels and
warms cuBLAS and the allocator); the next one captures the step in one
``torch.cuda.CUDAGraph`` and every later step copies its batch into the
graph's input buffers and replays it.  A failed capture raises: nothing
carries on eagerly.  On the CPU the same step function runs eagerly every
time, which is how the tests run it.

Ported here: one device, ``compute_dtype`` (float32 master weights,
gradients and aux states; narrow products summed in float32), the
``dtype_policy`` of the backward formulations, the sentinel
(off/skip/abort) with loss scaling (none, fixed or dynamic),
``grad_accum``, the optimizer-state round trip (with the device
generator's state, for a resume that draws the same masks) and
``reshape`` to new batch shapes (a graph per shape, one state).  Aux
states (BatchNorm's moving statistics) are float32 masters, cast to the
compute dtype for the forward like the params, and the step writes their
new values into them in place.  A mesh, tensor-parallel
``param_specs``, ``zero=1``, ``remat``, ``integrity``, tune plans
(``plan=``), the persisted program cache and the static analyses wait
for later slices of the port, and each raises :class:`MXNetError` naming
its slice.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError, _dtype, current_context
from ..executor import _GraphProgram
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray
from .optim import make_update_fn

__all__ = ["Trainer"]

# dynamic loss-scale schedule (the standard GradScaler constants): halve
# on a non-finite step, double after GROWTH_INTERVAL consecutive clean
# steps, clamp to [1, 2**24]
_LS_INIT = 2.0 ** 15
_LS_MAX = 2.0 ** 24
_LS_GROWTH_INTERVAL = 200

# MXNet-style output ops whose backward INJECTS the loss gradient and
# (with out_grad left False) discards the upstream cotangent: seed-side
# loss scaling cannot reach a backward that starts at one of these
_FIXED_LOSS_OPS = frozenset((
    "SoftmaxOutput", "Softmax", "SVMOutput", "MakeLoss",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput",
))

MESH_SLICE = "waits for the port's mesh and KVStore slice"
# batch dtypes narrowed on the way in, as the JAX package's arrays are
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _seeds_reach_grads(symbol) -> bool:
    """True when every graph output propagates its cotangent seed, i.e.
    no fixed-loss output op without ``out_grad=True`` sits at a head."""
    try:
        graph = json.loads(symbol.tojson())
    except Exception:      # noqa: BLE001 - unparseable: assume linear
        return True
    nodes = graph.get("nodes", [])
    for head in graph.get("heads", []):
        node = nodes[head[0]] if head and head[0] < len(nodes) else None
        if node is None:
            continue
        if node.get("op") in _FIXED_LOSS_OPS:
            attrs = node.get("attrs") or node.get("param") or {}
            if str(attrs.get("out_grad", "False")) not in ("True", "true",
                                                           "1"):
                return False
    return True


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching None/tensor/tuple/list/
    dict trees (an optimizer state, the params)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _structure(tree):
    """A tree's shape without its leaves: where the Nones are, each
    tuple's length, each dict's keys (an optimizer state: ``None``, a
    tensor, a 1-, 2- or 3-tuple, ``(None, tensor)``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    return "leaf"


@contextlib.contextmanager
def _float32_sums():
    """cuBLAS sums bfloat16 and float16 products in float32 inside this
    scope, as the JAX package's products under ``compute_dtype`` do
    (PyTorch's default lets cuBLAS keep split sums in the narrow dtype).
    The caller's settings come back after it; a graph captured inside
    keeps the GEMMs chosen there."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved


class Trainer:
    """Fused trainer for a Symbol on one device: the current context's
    (``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise).

    Usage::

        t = Trainer(softmax, optimizer)
        t.bind(data_shapes={"data": (256, 784)},
               label_shapes={"softmax_label": (256,)})
        t.init_params(mx.init.Xavier())
        outs = t.step({"data": x, "softmax_label": y})

    ``graph_captures`` and ``graph_replays`` count the CUDA graphs
    captured and replayed (0 on the CPU).
    """

    def __init__(self, symbol, optimizer, data_names: Sequence[str] = ("data",),
                 label_names: Sequence[str] = ("softmax_label",),
                 mesh=None, compute_dtype=None, param_specs=None,
                 remat: Optional[str] = None,
                 dtype_policy: Optional[str] = None,
                 sentinel: Optional[str] = None,
                 loss_scale=None,
                 sentinel_max_skips: Optional[int] = None,
                 ls_growth_interval: Optional[int] = None,
                 donate_batch: Optional[bool] = None,
                 zero: Optional[int] = None,
                 grad_accum: Optional[int] = None,
                 grad_dtype: Optional[str] = None,
                 integrity: Optional[str] = None,
                 integrity_period: Optional[int] = None,
                 plan=None):
        if mesh is not None or param_specs:
            raise MXNetError("a mesh (and its param_specs) %s" % MESH_SLICE)
        if plan is not None or os.environ.get("MXTPU_TUNE_PLAN"):
            raise MXNetError("tune plans (plan=, MXTPU_TUNE_PLAN) wait for "
                             "the port's autotune slice")
        self.symbol = symbol
        self.optimizer = optimizer
        self.prog = _GraphProgram(symbol)
        self.device = current_context().torch_device()
        self.data_names = list(data_names)
        self.label_names = [n for n in label_names
                            if n in self.prog.arg_names]
        self.compute_dtype = _dtype(compute_dtype) if compute_dtype else None

        def _knob(ctor, env_name, default):
            if ctor is not None:
                return ctor
            return os.environ.get(env_name) or default

        def _as_int(value, what):
            try:
                return int(value)
            except (TypeError, ValueError):
                raise MXNetError("%s=%r is not an integer" % (what, value)) \
                    from None

        remat = _knob(remat, "MXTPU_REMAT", "none")
        if remat not in ("", "none"):
            raise MXNetError("remat=%r: rematerialization waits for the "
                             "port's remat slice" % (remat,))
        # the backward formulations (op/bytediet.py): "bytediet" (the
        # default) or "legacy"
        self.dtype_policy = _knob(dtype_policy, "MXTPU_DTYPE_POLICY", None)
        if self.dtype_policy not in (None, "bytediet", "legacy"):
            raise MXNetError("unknown dtype_policy %r (bytediet|legacy)"
                             % (self.dtype_policy,))
        self.prog.dtype_policy = self.dtype_policy
        # --- step sentinel: the float32 gradients' global finiteness,
        # inside the step; a non-finite batch selects the old params,
        # aux and optimizer state, with no host round trip
        self.sentinel = sentinel if sentinel is not None \
            else os.environ.get("MXTPU_SENTINEL", "off")
        if self.sentinel not in ("off", "skip", "abort"):
            raise MXNetError("unknown sentinel mode %r (off|skip|abort)"
                             % (self.sentinel,))
        self.sentinel_max_skips = int(
            sentinel_max_skips if sentinel_max_skips is not None
            else os.environ.get("MXTPU_SENTINEL_MAX_SKIPS", "3"))
        # loss scale: None/off, "dynamic", or a fixed float.  It scales
        # the cotangent seeds, and the float32 gradients are unscaled
        # before the finiteness check and the update
        if loss_scale is None:
            loss_scale = os.environ.get("MXTPU_LOSS_SCALE", "") or None
        if loss_scale in ("off", "none", "0"):
            loss_scale = None
        if loss_scale is not None and loss_scale != "dynamic":
            loss_scale = float(loss_scale)
        self.loss_scale = loss_scale
        self._ls_applies = True
        if loss_scale is not None and not _seeds_reach_grads(symbol):
            logging.getLogger("mxtpu.trainer").warning(
                "loss scale requested, but an output op of this graph "
                "injects its loss gradient and discards upstream "
                "cotangents (SoftmaxOutput-style, out_grad=False): the "
                "seed-side scale cannot reach the backward; running "
                "with scaling INERT (skip/abort sentinel unaffected)")
            self._ls_applies = False
        self.ls_growth_interval = int(
            ls_growth_interval if ls_growth_interval is not None
            else os.environ.get("MXTPU_LS_GROWTH_INTERVAL",
                                str(_LS_GROWTH_INTERVAL)))
        self._sent = None          # device sentinel state, _init_sentinel
        zero = _as_int(_knob(zero, "MXTPU_ZERO", "0"), "zero (MXTPU_ZERO)")
        if zero not in (0, 1):
            raise MXNetError("zero=%r: supported stages are 0 (replicated "
                             "optimizer state) and 1 (state sharded along "
                             "the data axis)" % (zero,))
        if zero:
            raise MXNetError("zero=1 (optimizer state sharded along the "
                             "data axis) %s" % MESH_SLICE)
        grad_accum = _knob(grad_accum, "MXTPU_GRAD_ACCUM", "1")
        self.grad_accum = _as_int(grad_accum, "grad_accum (MXTPU_GRAD_ACCUM)")
        if self.grad_accum < 1:
            raise MXNetError("grad_accum=%r: need a microbatch count >= 1"
                             % (grad_accum,))
        # knobs one device has no use for yet: only their defaults
        if donate_batch:
            raise MXNetError("donate_batch=True: the step copies each batch "
                             "into its captured graph's input buffers; "
                             "donating the batch waits for a later slice "
                             "of the port")
        if grad_dtype not in (None, "f32", "float32"):
            raise MXNetError("grad_dtype=%r: the cross-chip gradient wire "
                             "dtype %s" % (grad_dtype, MESH_SLICE))
        if integrity is None:
            integrity = os.environ.get("MXTPU_INTEGRITY_MODE", "off")
        if integrity not in ("off", "fp", "vote", "audit"):
            raise MXNetError("unknown integrity mode %r (off|fp|vote|"
                             "audit)" % (integrity,))
        if integrity != "off" or integrity_period is not None:
            raise MXNetError("integrity=%r, integrity_period=%r: the state "
                             "fingerprints, votes and audits wait for the "
                             "port's resilience slice"
                             % (integrity, integrity_period))
        input_set = set(self.data_names) | set(self.label_names)
        self.param_names = [n for n in self.prog.arg_names
                            if n not in input_set]
        self.aux_names = list(self.prog.aux_names)
        self.has_rng = any(getattr(n.op, "uses_rng", False)
                           for n in self.prog.nodes if not n.is_variable)
        self.params = None
        self.aux = None
        self.opt_state = None
        self.num_update = optimizer.begin_num_update
        self._update_fn = None
        self._lr_cache = None
        # the step's lr and t: device scalars a captured graph reads
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._t = torch.zeros((), dtype=torch.int32, device=self.device)
        # CUDA graphs by batch signature: (graph, input buffers, outputs);
        # signatures whose eager warm-up step has run
        self._graphs = {}
        self._warm = set()
        self.graph_captures = 0
        self.graph_replays = 0

    # ------------------------------------------------------------------
    def bind(self, data_shapes: Dict[str, tuple],
             label_shapes: Optional[Dict[str, tuple]] = None):
        self._set_shapes(data_shapes, label_shapes)
        if self.has_rng and self.device.type == "cuda" and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            raise MXNetError(
                "this graph draws random numbers, and this torch (%s) cannot "
                "register the port's generator with a CUDA graph "
                "(CUDAGraph.register_generator_state)" % torch.__version__)
        self._build()
        return self

    def reshape(self, data_shapes: Dict[str, tuple],
                label_shapes: Optional[Dict[str, tuple]] = None):
        """Take batches of new shapes.  The parameters, aux states and
        optimizer state stay in their tensors, and each batch signature
        keeps its own CUDA graph (a shape seen before replays its graph;
        a new one warms up and is captured).  New shapes that would
        change a parameter's or an aux state's shape raise."""
        old = (self._arg_shapes, self._aux_shapes, self._input_shapes)
        self._set_shapes(data_shapes, label_shapes)
        changed = [n for n in self.param_names
                   if tuple(self._arg_shapes[n]) != tuple(old[0][n])]
        changed += [n for n in self.aux_names
                    if tuple(self._aux_shapes[n]) != tuple(old[1][n])]
        if changed:
            self._arg_shapes, self._aux_shapes, self._input_shapes = old
            raise MXNetError("reshape would change the shapes of %s; bind "
                             "a new trainer for that" % changed)
        return self

    def _set_shapes(self, data_shapes, label_shapes):
        """Infer every argument's shape from the batch shapes, and keep
        the inputs' (``_input_shapes``: what ``_device_batch`` takes)."""
        shapes = dict(data_shapes)
        shapes.update(label_shapes or {})
        arg_shapes, out_shapes, aux_shapes = self.symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % shapes)
        if self.grad_accum > 1 and out_shapes:
            # outputs are reassembled along dim 0 from the microbatches:
            # a REDUCED head would be stitched from per-microbatch pieces
            # instead of the big-batch value, so refuse
            bsz = shapes[self.data_names[0]][0] \
                if self.data_names and self.data_names[0] in shapes \
                else next(iter(shapes.values()))[0]
            for oname, oshape in zip(self.symbol.list_outputs(),
                                     out_shapes or []):
                if not oshape or oshape[0] != bsz:
                    raise MXNetError(
                        "grad_accum>1 needs batch-major graph outputs, but "
                        "%r has shape %s (batch %d): reduced-output heads "
                        "are not supported on this path"
                        % (oname, tuple(oshape or ()), bsz))
        arg_map = dict(zip(self.prog.arg_names, arg_shapes))
        input_shapes = {n: arg_map[n]
                        for n in self.data_names + self.label_names}
        if self.grad_accum > 1:
            for n, s in input_shapes.items():
                if s[0] % self.grad_accum:
                    raise MXNetError(
                        "grad_accum=%d does not divide the %r batch dim %d"
                        % (self.grad_accum, n, s[0]))
        self._arg_shapes = arg_map
        self._aux_shapes = dict(zip(self.aux_names, aux_shapes))
        self._input_shapes = input_shapes

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    force_init=False):
        """Parameters from ``arg_params``/``aux_params`` where given, else
        from ``initializer``, on the trainer's device; then a fresh
        optimizer state (``set_params`` writes the values and keeps the
        state).  A second call writes into the same tensors, so
        a captured step keeps reading them."""
        if self.params is not None and not force_init:
            return self
        initializer = initializer or Uniform(0.01)
        attrs = self.symbol.attr_dict()

        def _seed(n, shape, given):
            if given is not None and n in given:
                src = given[n]
                src = src.data if isinstance(src, NDArray) \
                    else torch.as_tensor(np.asarray(src))
                return src.to(self.device, copy=True)
            arr = NDArray(torch.zeros(shape, dtype=torch.float32,
                                      device=self.device))
            initializer(InitDesc(n, attrs.get(n, {})), arr)
            return arr.data

        params = {n: _seed(n, self._arg_shapes[n], arg_params)
                  for n in self.param_names}
        aux = {n: _seed(n, self._aux_shapes[n], aux_params)
               for n in self.aux_names}
        init_fn, self._update_fn = make_update_fn(self.optimizer,
                                                  self.param_names)
        with torch.no_grad():
            self.params = self._assign(self.params, params)
            self.aux = self._assign(self.aux, aux)
            self.opt_state = self._assign(self.opt_state, init_fn(params))
        if self.sentinel != "off" and self._sent is None:
            # once per trainer, not per (re-)init: the skip counters and
            # the effective update cursor survive a parameter refresh
            self._sent = self._init_sentinel(self.num_update)
        return self

    def _assign(self, old, new):
        """``new``'s values in ``old``'s tensors where the two trees match
        in structure, shapes and dtypes (a captured step keeps its
        addresses); else ``new``, and every captured graph is dropped."""
        pairs = list(zip(_leaves(old), _leaves(new)))
        same = old is not None and len(pairs) == len(_leaves(new)) == len(
            _leaves(old)) and all(a.shape == b.shape and a.dtype == b.dtype
                                  for a, b in pairs)
        if not same:
            self._graphs.clear()
            self._warm.clear()
            return new
        _tree_map(lambda a, b: a.copy_(b), old, new)
        return old

    def _init_sentinel(self, t, skips=0, scale=None):
        """Fresh device sentinel state.  ``t`` is the effective update
        counter (advanced only on clean steps, so a skipped batch leaves
        the optimizer's time axis where a dropped batch would);
        ``skips``/``consec``/``good`` count all skips, consecutive skips
        and the clean streak; ``scale`` is the current loss scale."""
        if scale is None:
            scale = _LS_INIT if self.loss_scale == "dynamic" else \
                float(self.loss_scale or 1.0)
        ints = dict(skips=skips, consec=0, good=0, t=t)
        sent = {k: torch.tensor(v, dtype=torch.int32, device=self.device)
                for k, v in ints.items()}
        sent["scale"] = torch.tensor(scale, dtype=torch.float32,
                                     device=self.device)
        return sent

    # ------------------------------------------------------------------
    def _build(self):
        """The update rule, and the step variant for this configuration
        (the JAX package's ``_build``, one device)."""
        _, self._update_fn = make_update_fn(self.optimizer, self.param_names)
        self._graphs.clear()
        self._warm.clear()

    def _forward(self, params, aux_vals, batch, is_train):
        """The graph over ``params`` and ``batch``, in the compute dtype:
        uint8 inputs become floats here, and under ``compute_dtype``
        every floating param, input and aux state is cast to it."""
        cd = self.compute_dtype
        batch = {n: (v.to(cd or torch.float32)
                     if v.dtype == torch.uint8 else v)
                 for n, v in batch.items()}
        if cd is not None:
            params = {n: (v.to(cd) if v.is_floating_point() else v)
                      for n, v in params.items()}
            batch = {n: (v.to(cd) if v.is_floating_point() else v)
                     for n, v in batch.items()}
            aux_vals = [(v.to(cd) if v.is_floating_point() else v)
                        for v in aux_vals]
        vals = [params[n] if n in params else batch[n]
                for n in self.prog.arg_names]
        return self.prog._eval(vals, list(aux_vals), self.device,
                               is_train=is_train)

    def _micro_backward(self, params, aux_vals, batch, scale):
        """One microbatch forward and backward: ``(outputs, new aux,
        float32 gradients)``, the loss scale still in the gradients."""
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            outs, new_aux = self._forward(leaves, aux_vals, batch, True)
        # cotangent seeds in the OUTPUT dtype (bfloat16 under
        # compute_dtype), the loss scale riding them; an expanded scalar,
        # so no seed the size of the logits is written
        heads, seeds = [], []
        for o in outs:
            if o.requires_grad:
                one = torch.ones((), dtype=o.dtype, device=o.device) \
                    if scale is None else scale.to(o.dtype)
                heads.append(o)
                seeds.append(one.expand(o.shape))
        names = list(leaves)
        grads = [None] * len(names)
        if heads:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        seeds, allow_unused=True)
        grads = {n: (torch.zeros(params[n].shape, dtype=torch.float32,
                                 device=params[n].device)
                     if g is None else g.float())
                 for n, g in zip(names, grads)}
        # aux states keep float32 master copies, as the params do
        new_aux = tuple(v.detach().float() if v.is_floating_point()
                        else v.detach() for v in new_aux)
        return tuple(o.detach() for o in outs), new_aux, grads

    def _accum_backward(self, params, aux_vals, batch, scale):
        """``grad_accum`` microbatches, their float32 gradients summed, the
        aux states threaded through them, their outputs restored to batch
        order (microbatch k holds rows ``[k*m, (k+1)*m)``)."""
        k = self.grad_accum
        if k == 1:
            return self._micro_backward(params, aux_vals, batch, scale)
        m = next(iter(batch.values())).shape[0] // k
        aux_c, gsum, outs_k = tuple(aux_vals), None, []
        for i in range(k):
            part = {n: v[i * m:(i + 1) * m] for n, v in batch.items()}
            outs, aux_c, g = self._micro_backward(params, aux_c, part, scale)
            gsum = g if gsum is None else {n: gsum[n] + g[n] for n in g}
            outs_k.append(outs)
        outs = tuple(torch.cat(parts, 0) for parts in zip(*outs_k))
        return outs, aux_c, gsum

    def _run_backward(self, params, aux, batch, scale):
        """Forward and backward (with accumulation) for one step: outputs,
        new aux states and float32 gradients with the loss scale divided
        back out."""
        aux_vals = [aux[n] for n in self.aux_names]
        with _float32_sums():
            outs, new_aux, grads = self._accum_backward(params, aux_vals,
                                                        batch, scale)
        if scale is not None:
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in grads.items()}
        return outs, new_aux, grads

    def _apply_update(self, params, grads, opt_state, lr, t):
        return self._update_fn(params, grads, opt_state, lr, t)

    def _write(self, params, aux, opt_state, sent=None):
        """Write a step's results into the state tensors, in place."""
        for n in self.param_names:
            self.params[n].copy_(params[n])
        for n, v in zip(self.aux_names, aux):
            self.aux[n].copy_(v)
        _tree_map(lambda a, b: a.copy_(b), self.opt_state, opt_state)
        if sent is not None:
            for k, v in sent.items():
                self._sent[k].copy_(v)

    def _step_plain(self, batch):
        outs, new_aux, grads = self._run_backward(self.params, self.aux,
                                                  batch, None)
        new_params, new_state = self._apply_update(
            self.params, grads, self.opt_state, self._lr, self._t)
        self._write(new_params, new_aux, new_state)
        return tuple(o.float() for o in outs)

    def _step_sentinel(self, batch):
        """The sentinel step: the plain step's math plus one global
        finiteness flag over the float32 gradients.  Non-finite: every
        state leaf selects its OLD value, the effective update counter
        ``t`` holds and the skip counters advance, all on the device.
        The host's ``num_update`` (the lr schedule) still advances, as a
        GradScaler's does."""
        sent = self._sent
        scaling = self.loss_scale is not None and self._ls_applies
        scale = sent["scale"] if scaling else None
        outs, new_aux, grads = self._run_backward(self.params, self.aux,
                                                  batch, scale)
        finite = torch.stack([torch.isfinite(grads[n]).all()
                              for n in self.param_names]).all()
        t_eff = sent["t"] + 1
        new_params, new_state = self._apply_update(
            self.params, grads, self.opt_state, self._lr, t_eff)

        def keep(new, old):
            return torch.where(finite, new, old)

        new_params = {n: keep(v, self.params[n])
                      for n, v in new_params.items()}
        new_state = _tree_map(keep, new_state, self.opt_state)
        new_aux = tuple(keep(v, self.aux[n])
                        for n, v in zip(self.aux_names, new_aux))
        good = torch.where(finite, sent["good"] + 1, 0)
        new_scale = sent["scale"]
        if self.loss_scale == "dynamic":
            grown = good >= self.ls_growth_interval
            new_scale = torch.where(
                finite,
                torch.where(grown, torch.clamp(new_scale * 2.0, max=_LS_MAX),
                            new_scale),
                torch.clamp(new_scale * 0.5, min=1.0))
            good = torch.where(grown, 0, good)
        new_sent = {
            "skips": sent["skips"] + torch.where(finite, 0, 1),
            "consec": torch.where(finite, 0, sent["consec"] + 1),
            "good": good,
            "t": torch.where(finite, t_eff, sent["t"]),
            "scale": new_scale,
        }
        self._write(new_params, new_aux, new_state, new_sent)
        return tuple(o.float() for o in outs)

    def _step_core(self, batch):
        with torch.no_grad():
            if self._sent is not None:
                return self._step_sentinel(batch)
            return self._step_plain(batch)

    def _graph_step(self, batch):
        """The step on a CUDA device: an eager warm-up the first time a
        batch signature is seen, one capture the second time, a replay
        every time after that.  Returns fresh output tensors."""
        sig = tuple((n, tuple(v.shape), v.dtype)
                    for n, v in sorted(batch.items()))
        entry = self._graphs.get(sig)
        if entry is None and sig not in self._warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                outs = self._step_core(batch)
            torch.cuda.current_stream(self.device).wait_stream(side)
            for o in outs:
                o.record_stream(torch.cuda.current_stream(self.device))
            self._warm.add(sig)
            return outs
        if entry is None:
            entry = self._capture(sig, batch)
        graph, inputs, outs = entry
        for n, v in batch.items():
            inputs[n].copy_(v, non_blocking=True)
        graph.replay()
        self.graph_replays += 1
        # the graph writes its outputs in place at every replay: hand out
        # copies, which stay valid after the next step
        return tuple(o.clone() for o in outs)

    def _capture(self, sig, batch):
        inputs = {n: torch.empty_like(v) for n, v in batch.items()}
        for n, v in batch.items():
            inputs[n].copy_(v)
        graph = torch.cuda.CUDAGraph()
        if self.has_rng:
            # each replay then draws the numbers after the last replay's
            graph.register_generator_state(_random.generator(self.device))
        torch.cuda.synchronize(self.device)
        try:
            # thread_local: an input pipeline's threads (fit's upload
            # worker, a loader's decoder) go on issuing their own streams'
            # work, allocations and event waits while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = self._step_core(inputs)
        except Exception as err:       # noqa: BLE001 - re-raised, named
            raise MXNetError("capturing the train step in a CUDA graph "
                             "failed: %s: %s" % (type(err).__name__, err)) \
                from err
        self.graph_captures += 1
        entry = self._graphs[sig] = (graph, inputs, outs)
        return entry

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict, fill_labels=False) -> Dict:
        """The batch on the device, 64-bit types narrowed.  With
        ``fill_labels`` a missing label is zeros of its bound shape (an
        inference forward of a predict iterator reads none)."""
        out = {}
        for n in self._input_shapes:
            if n not in batch and fill_labels and n in self.label_names:
                out[n] = torch.zeros(self._input_shapes[n],
                                     device=self.device)
                continue
            v = batch[n]
            if isinstance(v, NDArray):
                v = v.data
            elif not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[n] = v.to(device=self.device, dtype=_NARROW.get(v.dtype,
                                                                v.dtype))
        return out

    def step(self, batch: Dict, lr: Optional[float] = None) -> List[NDArray]:
        """One fused train step.  Returns the graph outputs (float32)."""
        if self.params is None:
            raise MXNetError("call bind() + init_params() first")
        self.num_update += 1
        self.optimizer.num_update = self.num_update
        if lr is None:
            if self.optimizer.lr_scheduler is not None:
                lr = self.optimizer.lr_scheduler(self.num_update)
            else:
                lr = self.optimizer.lr
        dev_batch = self._device_batch(batch)
        # one write of the lr device scalar per lr CHANGE, not per step
        if self._lr_cache != lr:
            self._lr.fill_(lr)
            self._lr_cache = lr
        self._t.fill_(max(1, self.num_update))
        if self.device.type == "cuda":
            outs = self._graph_step(dev_batch)
        else:
            outs = self._step_core(dev_batch)
        if self._sent is not None and self.sentinel == "abort":
            # abort accepts a device->host read per step: the point IS to
            # stop the moment K batches in a row went bad
            consec = int(self._sent["consec"])
            if consec >= self.sentinel_max_skips:
                raise MXNetError(
                    "step sentinel: %d consecutive non-finite "
                    "gradient steps (threshold %d) at update %d — "
                    "aborting (MXTPU_SENTINEL=abort)"
                    % (consec, self.sentinel_max_skips, self.num_update))
        return [NDArray(o) for o in outs]

    @property
    def sentinel_skips(self) -> int:
        """Total sentinel-skipped steps (a device read: poll it per epoch,
        not per step)."""
        if self._sent is None:
            return 0
        return int(self._sent["skips"])

    @property
    def loss_scale_value(self) -> float:
        """Current loss scale (1.0 when scaling is off)."""
        if self._sent is None:
            return 1.0
        return float(self._sent["scale"])

    def _eval(self, batch, is_train):
        dev_batch = self._device_batch(batch, fill_labels=not is_train)
        with torch.no_grad(), _float32_sums():
            outs, _ = self._forward(self.params,
                                    [self.aux[n] for n in self.aux_names],
                                    dev_batch, is_train)
        return [NDArray(o.float()) for o in outs]

    def forward(self, batch: Dict) -> List[NDArray]:
        """Inference forward (``is_train=False``), eager."""
        return self._eval(batch, False)

    def forward_train(self, batch: Dict) -> List[NDArray]:
        """Training-mode forward WITHOUT the update, for callers that read
        outputs between ``forward(is_train=True)`` and the step."""
        return self._eval(batch, True)

    # ------------------------------------------------------------------
    def get_opt_states(self) -> bytes:
        """Serialize ``(num_update, optimizer state, sentinel state or
        None, random state)``: the state as CPU tensors, the sentinel's
        counters and loss scale as numbers, and the device generator's
        state when the graph draws (Dropout), so a resumed run draws the
        masks the uninterrupted one would.  The port's own pickle
        format: the JAX package's files hold numpy arrays and do not
        load here."""
        state = _tree_map(lambda v: v.detach().cpu(), self.opt_state)
        sent = None if self._sent is None else \
            {k: v.item() for k, v in self._sent.items()}
        rng = _random.generator(self.device).get_state() \
            if self.has_rng else None
        return pickle.dumps((self.num_update, state, sent, {"rng": rng}))

    def set_opt_states(self, blob: bytes) -> None:
        """Restore :meth:`get_opt_states`' blob into the tensors a
        captured step reads, so a graph captured before and one captured
        after see the same state; ``num_update`` (and with it the lr and
        ``t`` scalars of the next step) and the sentinel as they were at
        the save."""
        try:
            loaded = pickle.loads(blob)
        except Exception as e:                      # noqa: BLE001
            raise MXNetError(
                "optimizer state blob is truncated or corrupt: %s: %s"
                % (type(e).__name__, e)) from e
        if not isinstance(loaded, tuple) or len(loaded) != 4:
            raise MXNetError("optimizer state blob holds a %s, not the "
                             "fused trainer's (num_update, state, "
                             "sentinel, extra) tuple"
                             % type(loaded).__name__)
        num_update, state, sent_host, extra = loaded
        if not isinstance(state, dict) or sorted(state) != sorted(
                self.opt_state):
            raise MXNetError("optimizer state blob holds %s, this trainer "
                             "trains %s" % (sorted(state) if isinstance(
                                 state, dict) else type(state).__name__,
                                 sorted(self.opt_state)))
        for n in sorted(state):
            if _structure(state[n]) != _structure(self.opt_state[n]):
                raise MXNetError(
                    "optimizer state blob holds %s's state as %s, this "
                    "trainer's %s keeps %s" % (
                        n, _structure(state[n]),
                        type(self.optimizer).__name__,
                        _structure(self.opt_state[n])))
        for cur, new in zip(_leaves(self.opt_state), _leaves(state)):
            if not isinstance(new, torch.Tensor):
                raise MXNetError(
                    "optimizer state blob holds %s leaves, not the port's "
                    "tensors (a JAX package's states do not load here)"
                    % type(new).__name__)
            if new.shape != cur.shape or new.dtype != cur.dtype:
                raise MXNetError("optimizer state blob holds a %s %s leaf "
                                 "where this trainer has %s %s"
                                 % (tuple(new.shape), new.dtype,
                                    tuple(cur.shape), cur.dtype))
        self.num_update = num_update
        self.optimizer.num_update = num_update
        with torch.no_grad():
            _tree_map(lambda cur, new: cur.copy_(new), self.opt_state,
                      state)
            if self.sentinel != "off":
                if sent_host is None:
                    # the saving trainer ran without the sentinel: seed
                    # the effective update counter from num_update (no
                    # skips recorded)
                    sent_host = {k: v.item() for k, v in
                                 self._init_sentinel(num_update).items()}
                for k, v in sent_host.items():
                    self._sent[k].fill_(v)
        rng = (extra or {}).get("rng")
        if rng is not None and self.has_rng:
            _random.generator(self.device).set_state(rng)

    def get_params(self):
        """Copies of the trained params and aux states, as NDArrays on the
        trainer's device (later steps do not change them)."""
        arg = {n: NDArray(v.clone()) for n, v in self.params.items()}
        aux = {n: NDArray(v.clone()) for n, v in self.aux.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params=None):
        """Write the given values into the params and aux states, as
        float32, in place."""
        with torch.no_grad():
            for store, given in ((self.params, arg_params),
                                 (self.aux, aux_params)):
                for n, v in (given or {}).items():
                    if n in store:
                        raw = v.data if isinstance(v, NDArray) \
                            else torch.as_tensor(np.asarray(v))
                        store[n].copy_(raw.to(torch.float32))
