"""The fused train step (``mxnet_tpu/parallel/trainer.py``): forward,
backward, the gradient sum over the worker processes and the optimizer
update as one step.

The JAX package jits the whole step into one XLA program.  Here the
step is one Python function over torch tensors: the graph walk recorded
on torch autograd, ``torch.autograd.grad`` for the float32 gradients,
their sum over the ranks of a ``data`` mesh, the optional finiteness
sentinel, and the optimizer's pure rule over every parameter, whose
results are written into the trainer's state tensors in place.  On a
CUDA device the first step with a given set of batch shapes runs eagerly
on a side stream (it builds the kernels and warms cuBLAS, the allocator
and the communicator); the next one captures the step in one
``torch.cuda.CUDAGraph`` and every later step copies its batch into the
graph's input buffers and replays it.  A failed capture raises: nothing
carries on eagerly.  On the CPU the same step function runs eagerly every
time, which is how the tests run it.

Data parallelism (``mesh=``, a :class:`~.mesh.Mesh` over every rank of
the ``torch.distributed`` group): each rank binds and feeds its own rows
of the global batch; the float32 gradients are summed over the ranks
inside the step (one all-reduce of every gradient packed into one
buffer).  BatchNorm normalises by the whole global batch, its
per-channel sums summed over the ranks inside the forward and the
backward, as the JAX package's step, one program over the mesh, does;
under the bfloat16 wire each rank normalises by its own rows and the
moving statistics are averaged, as the JAX package's shard_map'd
backward does.  Either way the ranks' state stays bitwise alike.  Over
NCCL the collectives are captured in the step's CUDA graph; with a
process group and a mesh the gradient sum is issued even at one rank
(an identity), so a one-card run captures a real NCCL launch.  Over gloo
a CUDA graph cannot hold the host-side collective, so the step runs
uncaptured every time (``graph_captures`` stays 0).
``zero=1`` reduce-scatters the gradients, updates each rank's rows of
every leaf (``mesh.zero_spec``: its optimizer state is 1/n of the leaf)
and all-gathers the parameters; ``grad_dtype="bf16"`` sends the
gradients as bfloat16 and sums them in float32
(``collectives.lowp_allreduce``, keeping the float32 shard under
``zero=1``).  Both, and the whole-batch BatchNorm, are inert at one
rank, as in the JAX package.  ``donate_batch=True`` gives each batch
tensor up to the step, as the JAX package donates its batch argument:
a tensor that is the whole of its storage (a staging buffer) is
emptied once the step has read it, and its memory freed; a view of a
larger storage (an on-card dataset's rows) is left as it is.  A caller
that feeds the same tensors again, or reads a batch member after the
step, keeps it off.  ``remat`` recomputes activations in the backward
(:func:`remat_policy`).

Also ported: ``compute_dtype`` (float32 master weights, gradients and
aux states; narrow products summed in float32), the ``dtype_policy`` of
the backward formulations, the sentinel (off/skip/abort) with loss
scaling (none, fixed or dynamic), ``grad_accum``, the optimizer-state
round trip (with the generator's state, for a resume that draws the
same masks; a ``zero=1`` blob holds whole leaves, so it restores across
``zero`` settings) and ``reshape`` to new batch shapes (a graph per
shape, one state).  Aux states (BatchNorm's moving statistics) are
float32 masters, cast to the compute dtype for the forward like the
params, and the step writes their new values into them in place.

The silent-data-corruption defence (``integrity``, ``integrity_period``;
``MXTPU_INTEGRITY_MODE``, ``MXTPU_INTEGRITY_PERIOD``), as the JAX
package's: every ``integrity_period``-th update runs a check.  ``fp``
and ``vote`` fingerprint the state the update reads (params, aux states
and optimizer state, ``integrity.py``) in a program of its own before
the step: on the card a second CUDA graph in the step graph's memory
pool, so every other step replays exactly the graph an unarmed trainer
replays.  ``vote`` gathers every rank's per-leaf fingerprints (inside
that graph over NCCL, through the host over gloo) and compares the
replicated leaves (ZeRO-1 shards sit out); a strict minority is blamed
at once, a one-against-one split when the rollback replay reaches the
step again.  ``audit`` (and ``vote`` without a data mesh of two or more
ranks) snapshots what the step reads, replays the step from it and
compares the two states' fingerprints.  A divergence raises
:class:`~mxnet_tpu_torch.integrity.IntegrityError`; ``Module.fit`` rolls
back to the newest verified checkpoint.  :meth:`Trainer.state_fingerprint`
is what a checkpoint's manifest records.  Tensor-parallel
``param_specs``, tune plans (``plan=``), the persisted program cache and
the static analyses wait for later slices of the port, and each raises
:class:`MXNetError` naming its slice.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults as _faults
from .. import integrity as _integrity
from .. import obs as _obs
from .. import random as _random
from ..base import MXNetError, _dtype, current_context
from ..executor import _GraphProgram
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray
from . import collectives as _coll
from .mesh import AXIS_SLICE, Mesh, PartitionSpec, zero_spec
from .optim import make_update_fn

__all__ = ["Trainer", "remat_policy"]

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


def _saved_ops(name):
    """The aten ops whose outputs a remat policy keeps."""
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default}
    if name == "dots":
        return dots
    return dots | {aten.convolution.default, aten._convolution.default}


def remat_policy(name):
    """The rematerialisation policy of the fused step: None (keep every
    residual), or the ``context_fn`` of a non-reentrant
    ``torch.utils.checkpoint`` over the whole forward.

    - ``"none"``: keep every residual (the most memory).
    - ``"convs_dots"``: keep only convolution and matmul outputs; the
      cheap epilogues (BatchNorm, ReLU, adds) are recomputed.
    - ``"dots"``: keep only matmul outputs (convolutions recomputed too).
    - ``"nothing"``: the backward recomputes the whole forward.

    The selective policies act on aten ops; a hand-written kernel behind
    a ``torch.autograd.Function`` (K1, the flash-attention forward) is
    not an aten op, so under every policy but ``none`` its forward runs
    again in the backward, as the JAX package's ``pallas_call`` is
    recomputed under ``dots_saveable``."""
    if name in (None, "", "none"):
        return None
    if name == "nothing":
        return lambda: (contextlib.nullcontext(), contextlib.nullcontext())
    if name not in ("convs_dots", "dots"):
        raise MXNetError("unknown remat policy %r (none|convs_dots|dots|"
                         "nothing)" % (name,))
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts)
    saved = _saved_ops(name)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


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
    """Fused trainer for a Symbol on the current context's device
    (``gpu(0)``, a worker's own card under the launcher, unless a ``with
    mx.cpu():`` scope says otherwise), data-parallel over the ranks of
    ``mesh``.

    Usage::

        t = Trainer(softmax, optimizer)
        t.bind(data_shapes={"data": (256, 784)},
               label_shapes={"softmax_label": (256,)})
        t.init_params(mx.init.Xavier())
        outs = t.step({"data": x, "softmax_label": y})

    ``graph_captures`` and ``graph_replays`` count the CUDA graphs
    captured and replayed (0 on the CPU, and over gloo).  ``comm_s`` sums
    the host seconds the collectives of the steps on a card took where
    they are staged through the host (gloo:
    ``collectives.host_comm_seconds``).
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
        if param_specs:
            raise MXNetError("param_specs: %s" % AXIS_SLICE)
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

        self.remat = _knob(remat, "MXTPU_REMAT", "none")
        self._remat_ctx = remat_policy(self.remat)
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
        self.zero = _as_int(_knob(zero, "MXTPU_ZERO", "0"),
                            "zero (MXTPU_ZERO)")
        if self.zero not in (0, 1):
            raise MXNetError("zero=%r: supported stages are 0 (replicated "
                             "optimizer state) and 1 (state sharded along "
                             "the data axis)" % (zero,))
        grad_accum = _knob(grad_accum, "MXTPU_GRAD_ACCUM", "1")
        self.grad_accum = _as_int(grad_accum, "grad_accum (MXTPU_GRAD_ACCUM)")
        if self.grad_accum < 1:
            raise MXNetError("grad_accum=%r: need a microbatch count >= 1"
                             % (grad_accum,))
        if donate_batch is None:
            donate_batch = os.environ.get("MXTPU_DONATE_BATCH", "0") \
                not in ("", "0", "false", "False")
        self.donate_batch = bool(donate_batch)
        grad_dtype = _knob(grad_dtype, "MXTPU_GRAD_DTYPE", "f32")
        wire = {"f32": "f32", "float32": "f32",
                "bf16": "bf16", "bfloat16": "bf16"}
        if grad_dtype not in wire:
            raise MXNetError("grad_dtype=%r: bf16 or f32 (the cross-chip "
                             "gradient wire dtype)" % (grad_dtype,))
        self.grad_dtype = wire[grad_dtype]
        # --- the data mesh: every rank of the process group, in order
        self.mesh = mesh
        self._ndata, self._rank = 1, 0
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise MXNetError("mesh=%r is not a parallel.Mesh" % (mesh,))
            world = _coll._process_count()
            if mesh.ranks != list(range(world)):
                raise MXNetError(
                    "a mesh over ranks %s in a process group of %d: the "
                    "fused step spans every rank" % (mesh.ranks, world))
            self._ndata, self._rank = world, _coll._process_index()
        # the in-step sum runs whenever a process group is up, even at
        # one rank; zero=1 and the bf16 wire only across ranks
        self._comm = mesh is not None and _coll.backend() is not None
        self._zero_on = self.zero == 1 and self._ndata > 1
        self._lowp_on = self.grad_dtype == "bf16" and self._ndata > 1
        self._host_comm = self._comm and _coll.backend() == "gloo" \
            and self.device.type == "cuda"
        # BatchNorm over the whole batch: the float32 wire's step (the
        # JAX package's GSPMD program); the bfloat16 wire's is per rank
        self._sync_bn = self._comm and self._ndata > 1 and not self._lowp_on
        self._in_step = False
        self._zero_dims = {}
        self.comm_s = 0.0
        # --- silent-data-corruption defence: a state fingerprint every
        # `integrity_period` updates, a vote over the data mesh's ranks
        # or a replay audit; a divergence raises IntegrityError and
        # Module.fit rolls back to the newest verified checkpoint
        if integrity is None:
            integrity = os.environ.get("MXTPU_INTEGRITY_MODE", "off")
        if integrity not in ("off", "fp", "vote", "audit"):
            raise MXNetError("unknown integrity mode %r (off|fp|vote|"
                             "audit)" % (integrity,))
        self.integrity = integrity
        integrity_period = _knob(integrity_period, "MXTPU_INTEGRITY_PERIOD",
                                 "100")
        self.integrity_period = _as_int(
            integrity_period, "integrity_period (MXTPU_INTEGRITY_PERIOD)")
        if self.integrity != "off" and self.integrity_period < 1:
            raise MXNetError("integrity_period=%r: need >= 1"
                             % (integrity_period,))
        self._integ_mode = "off"       # resolved at _build
        self._integ = None             # the check's carry (fp/vote)
        self._integ_paths = None       # state-leaf paths, vote column order
        self._integ_rep_mask = None    # which columns vote (replicated)
        self._integ_rep_idx = None     # the same, as a device index
        self._integ_external = False   # ZeRO-1 vote: raises before the step
        self._check = None             # the check's CUDA graph
        self._check_warm = False
        self.check_captures = 0
        self.check_replays = 0
        self.integrity_divergences = 0
        self.integrity_blamed = []     # resolved blame records
        self._integrity_pending = None  # divergence awaiting replay blame
        self.on_integrity_blame = None  # callback(record) on resolution
        input_set = set(self.data_names) | set(self.label_names)
        self.param_names = [n for n in self.prog.arg_names
                            if n not in input_set]
        self.aux_names = list(self.prog.aux_names)
        self.has_rng = any(getattr(n.op, "uses_rng", False)
                           for n in self.prog.nodes if not n.is_variable)
        # a node whose body runs Python on the host (a Custom op) cannot
        # be captured: such a step runs eagerly on the card, and this
        # names the nodes (None where the step is captured)
        from ..operator import uncapturable
        self.uncaptured = uncapturable(self.prog.nodes)
        # the ranks draw different masks (the JAX package folds the data
        # axis index into its key), from a generator of their own
        self._rank_gen = None
        if self.has_rng and self._ndata > 1:
            self._rank_gen = torch.Generator(device=self.device).manual_seed(
                _random._SEED + 1000003 * self._rank)
        # under remat, the recompute draws from a twin of the generator,
        # set to the generator's state before each step
        self._twin = torch.Generator(device=self.device) \
            if self.has_rng and self._remat_ctx is not None else None
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
        # the dim of each parameter whose rows a rank owns under zero=1
        # (mesh.zero_spec; None: no dim divides, the leaf stays whole);
        # dim 0 is also the bfloat16 wire's reduce-scatter
        n = self._ndata
        self._zero_dims = {}
        for m in self.param_names:
            spec = zero_spec(PartitionSpec(), arg_map[m], n) if n > 1 else ()
            self._zero_dims[m] = next(
                (d for d, e in enumerate(spec) if e == "data"), None)

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
            # under zero=1 each rank's state is born as its rows
            self.opt_state = self._assign(self.opt_state, init_fn(
                {m: self._shard(p, m) for m, p in params.items()}))
        if self.sentinel != "off" and self._sent is None:
            # once per trainer, not per (re-)init: the skip counters and
            # the effective update cursor survive a parameter refresh
            self._sent = self._init_sentinel(self.num_update)
        self._integ_setup()
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
            self._check, self._check_warm = None, False
            return new
        _tree_map(lambda a, b: a.copy_(b), old, new)
        return old

    # ------------------------------------------------------------------
    # ZeRO-1 rows and the collectives of the step
    def _shard(self, t, name):
        """This rank's rows of a whole leaf of ``name`` under zero=1 (a
        view; the leaf itself when ``name`` is not sharded)."""
        d = self._zero_dims.get(name)
        if d is None or not self._zero_on:
            return t
        k = t.shape[d] // self._ndata
        return t.narrow(d, self._rank * k, k)

    def _gather(self, shards, names):
        """Whole leaves from every rank's rows of ``names``: one
        all-gather of the rows packed into one buffer."""
        n = self._ndata
        flat = torch.cat([shards[m].movedim(self._zero_dims[m], 0)
                          .reshape(-1) for m in names])
        rows = _coll.all_gather(flat, n).reshape(n, -1)
        out, off = {}, 0
        for m in names:
            d, k = self._zero_dims[m], shards[m].numel()
            moved = list(shards[m].movedim(d, 0).shape)
            moved[0] *= n
            out[m] = rows[:, off:off + k].reshape(moved).movedim(0, d)
            off += k
        return out

    def _allreduce_flat(self, tensors):
        """The sum over every rank of each tensor: one all-reduce of
        them all, packed into one float32 buffer."""
        flat = torch.cat([t.reshape(-1) for t in tensors.values()])
        _coll.all_reduce_(flat)
        out, off = {}, 0
        for m, t in tensors.items():
            out[m] = flat[off:off + t.numel()].reshape(t.shape)
            off += t.numel()
        return out

    def _reduce_scatter_flat(self, grads, names):
        """Each rank's rows of the sum over ranks of ``names``' leaves:
        one reduce-scatter of the leaves' rows packed rank-major."""
        n = self._ndata
        # each leaf with its sharded dim first, as n rows: row i holds
        # rank i's slice
        rows = torch.cat([grads[m].movedim(self._zero_dims[m], 0)
                          .reshape(n, -1) for m in names], 1)
        mine = _coll.reduce_scatter(rows.reshape(-1), n)
        out, off = {}, 0
        for m in names:
            d = self._zero_dims[m]
            moved = list(grads[m].movedim(d, 0).shape)
            moved[0] //= n
            k = int(np.prod(moved))
            out[m] = mine[off:off + k].reshape(moved).movedim(0, d)
            off += k
        return out

    def _lowp_sum(self, grads):
        """``grad_dtype="bf16"``: ``collectives.lowp_allreduce`` over
        every leaf, the leaves packed into two calls.  The leaves whose
        dim 0 divides by n go in as n rows (row i: every leaf's rows of
        rank i), so one all-to-all serves them all (under zero=1 the
        float32 rows stay, as ``keep_shard`` keeps them); the rest go in
        as one row, which takes the all-gather and a float32 sum."""
        n, cd = self._ndata, torch.bfloat16
        split = [m for m in self.param_names if self._zero_dims[m] == 0]
        whole = [m for m in self.param_names if m not in split]
        out = {}
        if split:
            summed = _coll.lowp_allreduce(
                torch.cat([grads[m].reshape(n, -1) for m in split], 1),
                "data", n, cd, keep_shard=self._zero_on)
            off = 0
            for m in split:
                g = grads[m]
                size = g.numel() // n
                if self._zero_on:
                    out[m] = summed[0, off:off + size].reshape(
                        (g.shape[0] // n,) + tuple(g.shape[1:]))
                else:
                    out[m] = summed[:, off:off + size].reshape(g.shape)
                off += size
        if whole:
            summed = _coll.lowp_allreduce(
                torch.cat([grads[m].reshape(1, -1) for m in whole], 1),
                "data", n, cd)[0]
            off = 0
            for m in whole:
                g = summed[off:off + grads[m].numel()].reshape(grads[m].shape)
                out[m] = self._shard(g, m)
                off += grads[m].numel()
        return out

    def _sync_grads(self, grads):
        """The gradients summed over the data axis (under zero=1, this
        rank's rows of each sharded leaf)."""
        if self._lowp_on:
            return self._lowp_sum(grads)
        if not self._zero_on:
            return self._allreduce_flat(grads)
        split = [m for m in self.param_names
                 if self._zero_dims[m] is not None]
        out = self._reduce_scatter_flat(grads, split) if split else {}
        whole = {m: grads[m] for m in self.param_names if m not in out}
        if whole:
            out.update(self._allreduce_flat(whole))
        return out

    def _mean_aux(self, new_aux):
        """BatchNorm's moving statistics averaged over the ranks, where
        each normalises by its own rows (the bfloat16 wire), so every
        rank keeps the same aux states."""
        idx = [i for i, v in enumerate(new_aux) if v.is_floating_point()]
        if not idx:
            return new_aux
        summed = self._allreduce_flat({i: new_aux[i] for i in idx})
        out = list(new_aux)
        for i in idx:
            out[i] = summed[i] / self._ndata
        return tuple(out)

    def _rng(self):
        """The generator the graph's samplers draw from."""
        if self._rank_gen is not None:
            return self._rank_gen
        return _random.generator(self.device)

    def opt_state_bytes_per_chip(self) -> int:
        """Optimizer-state bytes this rank holds (1/n of a sharded
        leaf's under zero=1)."""
        return int(sum(v.numel() * v.element_size()
                       for v in _leaves(self.opt_state or {})))

    def grad_comm_bytes_per_step(self) -> int:
        """Per-rank gradient wire bytes of one step, by the ring model
        (0 without a data axis over more than one rank): float32,
        ``2(n-1)/n`` of the gradient bytes (an all-reduce; under zero=1
        a reduce-scatter of the sharded leaves, ``(n-1)/n``); bfloat16,
        ``collectives.lowp_comm_bytes`` per leaf."""
        n = self._ndata
        if n <= 1:
            return 0
        total = 0.0
        for m in self.param_names:
            shape = tuple(self._arg_shapes[m])
            size = int(np.prod(shape or (1,)))
            if self._lowp_on:
                total += _coll.lowp_comm_bytes(
                    shape, n, 2,
                    keep_shard=self._zero_on and self._zero_dims[m] == 0)
            elif self._zero_on and self._zero_dims[m] is not None:
                total += (n - 1) / n * size * 4
            else:
                total += 2 * (n - 1) / n * size * 4
        return int(total)

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
        self._check, self._check_warm = None, False
        self._resolve_integrity()

    def _forward(self, params, aux_vals, batch, is_train, rng=None):
        """The graph over ``params`` and ``batch``, in the compute dtype:
        uint8 inputs become floats here, and under ``compute_dtype``
        every floating param, input and aux state is cast to it.  The
        samplers draw from ``rng`` (the trainer's generator by
        default).  Inside the step under the float32 wire, BatchNorm's
        sums cover every rank's rows (``forward_train`` keeps a rank's:
        it runs no collective)."""
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
        sync = self._sync_bn and self._in_step
        return self.prog._eval(vals, list(aux_vals), self.device,
                               is_train=is_train,
                               rng=rng if rng is not None else self._rng(),
                               batch_sum=_coll.sum_over_ranks if sync
                               else None,
                               batch_ranks=self._ndata if sync else 1)

    def _remat_forward(self, leaves, aux_vals, batch):
        """The training forward under a non-reentrant
        ``torch.utils.checkpoint`` with the remat policy's context.  The
        recompute draws from the twin generator, which ``step`` sets to
        the generator's state before the forward, so Dropout draws the
        masks of the forward again (``preserve_rng_state`` would restore
        only PyTorch's default generators, not the port's)."""
        from torch.utils.checkpoint import checkpoint
        names = list(leaves)
        calls = []

        def fwd(*values):
            rng = self._twin if calls else None
            calls.append(1)
            return self._forward(dict(zip(names, values)), aux_vals, batch,
                                 True, rng=rng)

        return checkpoint(fwd, *(leaves[m] for m in names),
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=self._remat_ctx)

    def _micro_backward(self, params, aux_vals, batch, scale):
        """One microbatch forward and backward: ``(outputs, new aux,
        float32 gradients)``, the loss scale still in the gradients."""
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            if self._remat_ctx is None:
                outs, new_aux = self._forward(leaves, aux_vals, batch, True)
            else:
                outs, new_aux = self._remat_forward(leaves, aux_vals, batch)
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
        if self._comm:
            grads = self._sync_grads(grads)
            if not self._sync_bn:
                new_aux = self._mean_aux(new_aux)
        if scale is not None:
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in grads.items()}
        return outs, new_aux, grads

    def _apply_update(self, params, grads, opt_state, lr, t):
        """The optimizer's rule; under zero=1 on this rank's rows of each
        sharded leaf, whose updated rows are then all-gathered."""
        if not self._zero_on:
            return self._update_fn(params, grads, opt_state, lr, t)
        rows = {m: self._shard(p, m) for m, p in params.items()}
        new_rows, new_state = self._update_fn(rows, grads, opt_state, lr, t)
        split = [m for m in self.param_names
                 if self._zero_dims[m] is not None]
        new_params = dict(new_rows)
        if split:
            new_params.update(self._gather(new_rows, split))
        return new_params, new_state

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
        if self._zero_on:
            # each rank holds its rows: the verdict is every rank's
            bad = _coll.all_reduce_((~finite).float().reshape(1))
            finite = bad[0] == 0
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
        self._in_step = True
        try:
            with torch.no_grad():
                if self._sent is not None:
                    return self._step_sentinel(batch)
                return self._step_plain(batch)
        finally:
            self._in_step = False

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
            graph.register_generator_state(self._rng())
            if self._twin is not None:
                graph.register_generator_state(self._twin)
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
            if self.donate_batch and v.numel() == 0 \
                    and math.prod(self._input_shapes[n]):
                raise MXNetError(
                    "batch member %r is empty: a tensor given up to an "
                    "earlier step (donate_batch=True) cannot be fed again"
                    % (n,))
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
        # whole-host death, SIGKILL-faithful, before this rank's step
        # enters its collectives (an elastic run meets the same directive
        # one layer up, in ElasticCoordinator.guard)
        if _faults.hit("host_dead", step=self.num_update,
                       rank=_coll._process_index()):
            os._exit(137)
        dev_batch = self._device_batch(batch)
        # the nan_grad fault: a poisoned batch, so the backward makes
        # non-finite gradients and the sentinel's path runs for real
        if _faults.hit("nan_grad", step=self.num_update):
            dev_batch = self._poison_batch(dev_batch)
        # one write of the lr device scalar per lr CHANGE, not per step
        if self._lr_cache != lr:
            self._lr.fill_(lr)
            self._lr_cache = lr
        self._t.fill_(max(1, self.num_update))
        due = self._integ_mode != "off" and \
            self.num_update % self.integrity_period == 0
        check_now = due and self._integ_mode in ("fp", "vote")
        audit_now = due and self._integ_mode == "audit"
        c0 = _coll.host_comm_seconds()
        if check_now:
            # fp/vote: the state this update reads, as the JAX package's
            # check-step program fingerprints its incoming state
            with _obs.span("train.integrity",
                           attrs={"mode": self._integ_mode}):
                self._run_check()
                if self._integ_external:
                    # ZeRO-1: the vote's verdict before the step, as the
                    # JAX package's standalone vote gives it
                    self._integrity_after_check()
                    check_now = False
        saved = self._audit_snapshot(dev_batch) if audit_now else None
        outs = self._run_step(dev_batch)
        if self.donate_batch:
            self._donate(dev_batch, outs)
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
        # the bitflip fault: one mantissa bit of a state leaf, on one
        # rank's copy, AFTER the update (a corrupt write the sentinel
        # never sees; the next integrity check has to)
        if _faults.active("bitflip"):
            self._apply_bitflip_faults()
        if audit_now:
            with _obs.span("train.integrity", attrs={"mode": "audit"}):
                self._audit_check(saved)
        self.comm_s += _coll.host_comm_seconds() - c0
        if check_now:
            self._integrity_after_check()
        return [NDArray(o) for o in outs]

    def _run_step(self, dev_batch):
        """The step on the batch: the captured graph's path on a card
        (unless the collectives go through the host), else eager."""
        if self._twin is not None:
            self._twin.set_state(self._rng().get_state())
        if self.device.type == "cuda" and not self._host_comm \
                and self.uncaptured is None:
            return self._graph_step(dev_batch)
        return self._step_core(dev_batch)

    def _poison_batch(self, dev_batch: Dict) -> Dict:
        """The first floating input times NaN (the ``nan_grad`` fault):
        its shape, dtype and device kept."""
        out = dict(dev_batch)
        for n in self.data_names + self.label_names:
            v = out.get(n)
            if v is not None and v.is_floating_point():
                out[n] = v * float("nan")
                return out
        raise MXNetError("nan_grad fault: no floating input to poison "
                         "among %s" % (list(dev_batch),))

    def _donate(self, batch, outs):
        """Give up each batch tensor the step has read (``donate_batch``):
        one that is the whole of its storage is emptied (``set_()``), so
        its memory goes back to the allocator once the step's work on it
        is done; a view of a larger storage, and a storage an output
        shares, stay."""
        kept = {o.untyped_storage().data_ptr() for o in outs}
        for v in batch.values():
            store = v.untyped_storage()
            if (v.storage_offset() or store.data_ptr() in kept
                    or store.nbytes() != v.numel() * v.element_size()):
                continue
            if v.is_cuda:
                v.record_stream(torch.cuda.current_stream(v.device))
            v.set_()

    # ------------------------------------------------------------------
    # the silent-data-corruption defence
    def _resolve_integrity(self):
        """The requested mode against this trainer's topology: ``vote``
        needs a data mesh of two or more ranks and falls back to the
        replay audit without one, as in the JAX package."""
        mode = self.integrity
        if mode == "vote" and (self._ndata <= 1 or not self._comm):
            logging.getLogger("mxtpu.integrity").info(
                "integrity=vote needs a >=2-way pure-data mesh; "
                "falling back to the deterministic replay audit")
            mode = "audit"
        self._integ_mode = mode
        self._integ_external = mode == "vote" and self._zero_on

    def _integ_setup(self):
        """The state-leaf paths in vote-column order, which columns vote
        (every leaf but a ZeRO-1 shard), and the check's carry: each
        rank's per-leaf fingerprints and the agreement flag, on the
        device.  Made once the optimizer state exists."""
        if self._integ_mode == "off":
            return
        named = self._named_state()
        paths = [p for p, _ in named]
        self._integ_paths = paths
        self._integ_rep_mask = np.array(
            [not self._is_shard(p) for p in paths], bool)
        # the weights for the longest leaf, whole (what state_fingerprint
        # reads under zero=1 too), before any capture
        _integrity.reserve(self.device, max(
            _integrity.word_count(v) * (self._ndata if self._is_shard(p)
                                        else 1) for p, v in named))
        self._integ_salts = torch.tensor(
            [_integrity.path_salt(p) for p in paths], dtype=torch.int64,
            device=self.device)
        if self._integ is None:
            rows = self._ndata if self._integ_mode == "vote" else 1
            self._integ = {
                "leaf": torch.zeros((rows, len(paths)), dtype=torch.int64,
                                    device=self.device),
                "agree": torch.ones((), dtype=torch.int32,
                                    device=self.device)}
            self._integ_rep_idx = torch.as_tensor(
                np.where(self._integ_rep_mask)[0], dtype=torch.int64,
                device=self.device)

    def _is_shard(self, path):
        """Whether a state leaf holds this rank's rows of a ZeRO-1 leaf
        (its bits legitimately differ between ranks)."""
        ns, _, rest = path.partition(":")
        return ns == "opt" and self._zero_on and \
            self._zero_dims.get(rest.split("[", 1)[0]) is not None

    def _named_state(self, whole=False):
        """The state's ``(path, tensor)`` leaves (``integrity``'s order):
        the live tensors, this rank's rows of a ZeRO-1 leaf; with
        ``whole``, the optimizer state's whole leaves (gathered: a
        collective under zero=1)."""
        opt_state = self._whole_state() if whole else self.opt_state
        return _integrity.named_state_leaves(self.params, self.aux,
                                             opt_state)

    @staticmethod
    def _leaf_fps(named):
        """Per-leaf fingerprints of ``named``: int64, one a leaf, on the
        device."""
        return torch.stack([_integrity.leaf_fingerprint(v) for _, v in named])

    def _fingerprints(self, named):
        """Per-leaf fingerprints of ``named`` and their global fold."""
        lf = self._leaf_fps(named)
        salts = torch.tensor([_integrity.path_salt(p) for p, _ in named],
                             dtype=torch.int64, device=lf.device)
        return lf, _integrity.fold_fingerprints(lf, salts)

    def _check_core(self):
        """The check: this rank's per-leaf fingerprints and, under
        ``vote``, every rank's gathered, the replicated columns
        compared; written into the carry (no host copy: a CUDA graph
        holds it)."""
        lf = self._leaf_fps(self._named_state())
        integ = self._integ
        if self._integ_mode == "vote":
            mat = _coll.all_gather(lf.reshape(1, -1), self._ndata)
            integ["leaf"].copy_(mat)
            if self._integ_rep_idx.numel():
                sub = mat.index_select(1, self._integ_rep_idx)
                integ["agree"].copy_((sub == sub[0:1]).all())
            else:
                integ["agree"].fill_(1)
        else:
            integ["leaf"].copy_(lf.reshape(1, -1))
            integ["agree"].fill_(1)

    def _run_check(self):
        """The check, on a card as a CUDA graph of its own (after one
        eager run, as a step is), in the memory pool of a step graph
        where one is captured; eager where the collectives go through
        the host, and on the CPU."""
        if self.device.type != "cuda" or self._host_comm:
            self._check_core()
            return
        if self._check is None:
            if not self._check_warm:
                self._check_core()
                self._check_warm = True
                return
            graph = torch.cuda.CUDAGraph()
            pool = next((g.pool() for g, _, _ in self._graphs.values()),
                        None)
            torch.cuda.synchronize(self.device)
            try:
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self._check_core()
            except Exception as err:   # noqa: BLE001 - re-raised, named
                raise MXNetError("capturing the integrity check in a CUDA "
                                 "graph failed: %s: %s"
                                 % (type(err).__name__, err)) from err
            self._check = graph
            self.check_captures += 1
        self._check.replay()
        self.check_replays += 1

    def _integrity_after_check(self):
        """Read the check's agreement flag.  On a disagreement: the
        divergence record, the strict minority blamed when there is
        one, and IntegrityError.  On an agreeing check at the step of a
        recorded one-against-one divergence (the rollback replay): the
        replica whose recorded row matches the honest replay is
        exonerated, the others blamed."""
        agree = bool(int(self._integ["agree"]))
        pend = self._integrity_pending
        rep = np.where(self._integ_rep_mask)[0]
        log = logging.getLogger("mxtpu.integrity")
        if agree:
            if pend is not None and pend.get("mode") == "vote" \
                    and pend.get("step") == self.num_update:
                self._integrity_pending = None
                mat = self._integ["leaf"].cpu().numpy()
                fresh = [int(v) for v in mat[0][rep]]
                rows = pend.get("fps") or []
                exonerated = [r for r in range(len(rows))
                              if [int(rows[r][c]) for c in rep] == fresh]
                blamed = sorted(set(range(len(rows))) - set(exonerated)) \
                    if exonerated else None
                pend["blamed"] = blamed
                if blamed:
                    self.integrity_blamed.append(pend)
                    log.warning(
                        "integrity: rollback replay of update %d matches "
                        "replica(s) %s — BLAMING replica(s) %s for the "
                        "recorded divergence (leaves %s)", self.num_update,
                        exonerated, blamed, pend.get("leaves"))
                    if self.on_integrity_blame is not None:
                        self.on_integrity_blame(pend)
                else:
                    log.warning(
                        "integrity: rollback replay of update %d matches "
                        "no recorded replica — blame indeterminate "
                        "(corruption predated the check window)",
                        self.num_update)
            return
        mat = self._integ["leaf"].cpu().numpy()
        _, blamed, div_cols = _integrity.blame_minority(mat, rep)
        record = {"step": int(self.num_update), "mode": "vote",
                  "world": int(mat.shape[0]),
                  "fps": [[int(v) for v in row] for row in mat],
                  "leaves": [self._integ_paths[c] for c in div_cols],
                  "blamed": blamed}
        self.integrity_divergences += 1
        if blamed is not None:
            self.integrity_blamed.append(record)
            if self.on_integrity_blame is not None:
                self.on_integrity_blame(record)
            self._integrity_pending = None
        else:
            # no strict majority (two replicas): the rollback replay of
            # this step resolves the blame (the agreeing branch above)
            self._integrity_pending = record
        raise _integrity.IntegrityError(
            "integrity vote FAILED at update %d: replicas disagree on %d "
            "replicated state leaf/leaves %s — blamed replica(s): %s; "
            "roll back to the last verified checkpoint and re-step"
            % (self.num_update, len(div_cols), record["leaves"][:4],
               blamed if blamed is not None else
               "indeterminate (no strict majority)"), record)

    def _state_tensors(self):
        """Every tensor the step reads and writes besides its batch."""
        return (list(self.params.values()) + list(self.aux.values())
                + _leaves(self.opt_state)
                + (list(self._sent.values()) if self._sent else []))

    def _audit_snapshot(self, dev_batch):
        """Copies of what the step reads: the state, the sentinel, the
        batch (when the step gives it up) and the generator's state; the
        ``t`` and ``lr`` scalars stay as the step set them."""
        state = [v.clone() for v in self._state_tensors()]
        batch = {n: v.clone() for n, v in dev_batch.items()} \
            if self.donate_batch else dev_batch
        rng = self._rng().get_state() if self.has_rng else None
        return state, batch, rng

    def _audit_check(self, saved):
        """The audit: the step run again from the snapshot, the two
        states' global fingerprints compared, the live result kept.  A
        step is deterministic, so any difference (a flaky ALU, a corrupt
        write, the injected ``bitflip``) is a divergence; a kernel that
        is not bitwise repeatable would show here too."""
        state, batch, rng = saved
        tensors = self._state_tensors()
        self._run_check()
        lf_live = self._integ["leaf"][0].clone()
        live = [v.clone() for v in tensors]
        with torch.no_grad():
            for v, old in zip(tensors, state):
                v.copy_(old)
        if rng is not None:
            self._rng().set_state(rng)
        self._run_step(batch)
        self._run_check()
        lf_replay = self._integ["leaf"][0]
        with torch.no_grad():
            for v, kept in zip(tensors, live):
                v.copy_(kept)
        fp_live = int(_integrity.fold_fingerprints(lf_live,
                                                   self._integ_salts))
        fp_replay = int(_integrity.fold_fingerprints(lf_replay,
                                                     self._integ_salts))
        if fp_live == fp_replay:
            return
        # the record names the leaves whose bits differ (the JAX
        # package's audit record leaves them out)
        differ = (lf_live != lf_replay).tolist()
        record = {"step": int(self.num_update), "mode": "audit",
                  "world": 1, "fps": [[fp_live], [fp_replay]],
                  "leaves": [p for p, d in zip(self._integ_paths, differ)
                             if d],
                  "blamed": None}
        self.integrity_divergences += 1
        raise _integrity.IntegrityError(
            "integrity audit: update %d executed twice from identical "
            "inputs produced different state fingerprints (%08x vs "
            "replay %08x) — silent corruption during execution; roll "
            "back to the last verified checkpoint"
            % (self.num_update, fp_live, fp_replay), record)

    def _apply_bitflip_faults(self):
        """Consume the armed ``bitflip`` directives: each rank of the
        data axis is asked in turn (every process consumes the same
        directive, once), and the process that holds the targeted
        rank's copy flips the matched leaf, in place."""
        for rank in range(max(1, self._ndata)):
            payload = _faults.hit_params("bitflip", step=self.num_update,
                                         rank=rank)
            if payload is None:
                continue
            pattern = str(payload.get("leaf", "*"))
            bit = int(payload.get("bit", 12))
            named = self._named_state()
            f32_paths = [p for p, v in named if v.dtype == torch.float32]
            target = _integrity.match_leaf(pattern, f32_paths)
            if target is None:
                raise MXNetError(
                    "bitflip fault: leaf glob %r matches no f32 state "
                    "leaf (have %s%s)"
                    % (pattern, f32_paths[:6],
                       "..." if len(f32_paths) > 6 else ""))
            _integrity.bitflip(dict(named)[target], rank, bit=bit,
                               my_rank=self._rank if self._ndata > 1
                               else None)
            logging.getLogger("mxtpu.integrity").warning(
                "bitflip fault fired: leaf %s bit %d rank %d at update %d",
                target, bit, rank, self.num_update)

    def _set_state_leaf(self, path: str, value) -> None:
        """Write ``value`` into the state leaf at ``path``, in place."""
        for p, v in self._named_state():
            if p == path:
                with torch.no_grad():
                    v.copy_(value)
                return
        raise MXNetError("no state leaf at %r" % (path,))

    def _save_vote_check(self):
        """The ranks' agreement on the current state before a
        fingerprint goes into a manifest: a corruption that lands
        between the last check and a save must not be hashed into a
        'verified' checkpoint.  A gate, not a periodic check: the carry
        and the divergence counts stay as they are."""
        lf = self._leaf_fps(self._named_state())
        mat = _coll.all_gather(lf.reshape(1, -1), self._ndata).cpu().numpy()
        rep_cols = np.where(self._integ_rep_mask)[0]
        agree, blamed, div_cols = _integrity.blame_minority(mat, rep_cols)
        if agree:
            return
        raise _integrity.IntegrityError(
            "state_fingerprint REFUSED at update %d: replicas disagree "
            "on replicated state leaf/leaves %s (blamed replica(s): %s) "
            "— stamping this state would mint a verified-but-corrupt "
            "checkpoint; the save stays CRC-only and the next integrity "
            "check rolls back past it"
            % (self.num_update,
               [self._integ_paths[c] for c in div_cols][:4], blamed))

    def state_fingerprint(self) -> dict:
        """The device-computed fingerprint of the params, aux states and
        optimizer state (whole leaves: gathered under zero=1, so every
        rank calls it), the record ``CheckpointManager.save`` writes
        into the manifest.  Under ``vote`` the ranks must agree first
        (else IntegrityError)."""
        if self.params is None:
            raise MXNetError("state_fingerprint needs bind()+init_params()")
        if self._integ_mode == "vote":
            self._save_vote_check()
        named = self._named_state(whole=True)
        lf, gfp = self._fingerprints(named)
        return _integrity.manifest_record(
            int(gfp), {p: int(v) for (p, _), v in zip(named, lf.tolist())},
            mode=self._integ_mode)

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
    def _whole_state(self):
        """The optimizer state with every rank's rows of a sharded leaf
        gathered (a collective under zero=1: every rank calls it)."""
        if not self._zero_on:
            return self.opt_state
        out = {}
        for m, tree in self.opt_state.items():
            d = self._zero_dims[m]
            rows = tuple(self._shard(self.params[m], m).shape)

            def whole(v, m=m, d=d, rows=rows):
                if d is None or tuple(v.shape) != rows:
                    return v
                return self._gather({m: v}, [m])[m]
            out[m] = _tree_map(whole, tree)
        return out

    def get_opt_states(self) -> bytes:
        """Serialize ``(num_update, optimizer state, sentinel state or
        None, random state)``: the state as CPU tensors (whole leaves,
        gathered from every rank under zero=1, so a blob restores across
        ``zero`` settings), the sentinel's counters and loss scale as
        numbers, and the generator's state when the graph draws
        (Dropout), so a resumed run draws the masks the uninterrupted
        one would.  The port's own pickle format: the JAX package's
        files hold numpy arrays and do not load here."""
        state = _tree_map(lambda v: v.detach().cpu(), self._whole_state())
        sent = None if self._sent is None else \
            {k: v.item() for k, v in self._sent.items()}
        rng = self._rng().get_state() if self.has_rng else None
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
        if self._zero_on:
            # this rank's rows of each whole leaf of a sharded weight
            state = {m: _tree_map(
                lambda v, m=m: self._shard(v, m) if isinstance(
                    v, torch.Tensor) and tuple(v.shape) == tuple(
                        self._arg_shapes[m]) else v, tree)
                for m, tree in state.items()}
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
            self._rng().set_state(rng)

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
