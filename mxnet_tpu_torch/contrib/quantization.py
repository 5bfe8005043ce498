"""Calibrated int8 quantization for serving
(``mxnet_tpu/contrib/quantization.py``).

Weights are STORED int8 with per-output-channel float scales and
dequantized inside the forward (a ``Cast`` and a multiply before the
consumer), so weight reads cost 1 byte an element while the products
run in the serving dtype.  On the card the dequantize is its own pair
of PyTorch kernels before each cuBLAS/cuDNN product.

``quantize_model(sym, arg_params)`` is weights-only: a rewritten symbol
whose quantized weight variables carry ``__dtype__`` attrs, so binding
allocates true int8 storage (a post-bind cast would be undone by
``copyto``'s cast to the destination), plus the matching quantized
parameters.  ``Embedding`` tables quantize per ROW and dequantize AFTER
the gather, so the full float table is never made.

``calibrate_model(sym, arg_params, aux_params, calib_iter)`` is static
post-training quantization: the float forward over a calibration set
measures the range of every activation feeding a quantized conv/FC (at
the producing node), and the emitted symbol quantizes those inputs to
int8 with the resulting per-tensor scales.  Numerically sensitive ops
(softmax, BatchNorm, the norms, the output head's input) stay in the
compute dtype, and the emission report names every op kept float and
why (``analysis.core.Finding`` records).

:func:`evaluate_gate` is the accuracy gate: argmax agreement with the
float model on a holdout and the top-1 delta where labels are known.

Quantized weights and scales are made on the host with numpy, so they
are bitwise the JAX package's; ``quant_tag`` and
``CalibrationResult.digest`` are computed as there.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from ..base import MXNetError

__all__ = ["quantize_params", "quantize_model", "calibrate_model",
           "quant_tag", "CalibrationResult", "evaluate_gate"]

_DEFAULT_OPS = ("FullyConnected", "Convolution", "Deconvolution",
                "Embedding")

# ops whose weight gets a per-output-channel scale and whose DATA input
# is eligible for static activation quantization (Embedding's data
# input is integer ids — never quantized)
_DENSE_OPS = ("FullyConnected", "Convolution", "Deconvolution")

# which weight axis indexes OUTPUT channels, per op (FC/Conv store
# weights (Cout, ...); Deconvolution stores (Cin, Cout/g, *k) —
# mxnet_tpu/op/nn.py — so its per-output-channel axis is 1; Embedding
# tables are (vocab, dim) and scale per ROW so the gather can fetch the
# row's scale alongside the row)
_CHANNEL_AXIS = {"FullyConnected": 0, "Convolution": 0,
                 "Deconvolution": 1, "Embedding": 0}

# numerically sensitive ops: always kept in the compute dtype.  The
# emission report records one finding per instance so the "what stayed
# float" story is explicit rather than implicit.
_SENSITIVE_OPS = {
    "SoftmaxOutput": "softmax normalization is exponent-dominated",
    "softmax": "softmax normalization is exponent-dominated",
    "log_softmax": "log-domain normalization",
    "SoftmaxActivation": "softmax normalization is exponent-dominated",
    "BatchNorm": "running statistics / variance rescale",
    "LayerNorm": "mean/variance reduction",
    "InstanceNorm": "mean/variance reduction",
    "L2Normalization": "norm reduction",
    "LRN": "cross-channel normalization",
}

# output heads: the classifier / regression layer feeding one of these
# keeps its INPUT activation float — logit margins are exactly what the
# accuracy gate measures, so the head is the worst place to inject
# quantization noise for the least memory savings (its input is one
# activation row, not a weight table).
_HEAD_OPS = ("SoftmaxOutput", "LinearRegressionOutput",
             "LogisticRegressionOutput", "MAERegressionOutput",
             "SVMOutput", "softmax")


def _quantize_weight(w, dtype="int8", axis=0):
    """Per-output-channel symmetric quantization along ``axis``.

    Returns (wq int8 ndarray, scale float32 broadcastable to w)."""
    if dtype != "int8":
        raise MXNetError("only int8 weight quantization is supported")
    arr = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
    reduce_axes = tuple(a for a in range(arr.ndim) if a != axis)
    flat = np.abs(arr).max(axis=reduce_axes)
    scale = (flat / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    sshape = [1] * arr.ndim
    sshape[axis] = arr.shape[axis]
    scale_b = scale.reshape(sshape)
    wq = np.clip(np.rint(arr / scale_b), -127, 127).astype(np.int8)
    return wq, scale_b


def quantize_params(arg_params, weight_names, quantized_dtype="int8"):
    """Quantize the named weights; other params pass through unchanged.

    ``weight_names``: mapping name -> output-channel axis (a set is
    accepted too, meaning axis 0 for every name)."""
    from .. import ndarray as nd
    if not isinstance(weight_names, dict):
        weight_names = {n: 0 for n in weight_names}
    out = {}
    for name, arr in arg_params.items():
        if name in weight_names:
            wq, scale = _quantize_weight(arr, quantized_dtype,
                                         axis=weight_names[name])
            out[name + "_quant"] = nd.array(wq, dtype=np.int8)
            out[name + "_quant_scale"] = nd.array(scale)
        else:
            out[name] = arr
    return out


def quant_tag(sym):
    """The quantization tier tag stamped on a quantized symbol's output
    nodes (``__quantized__`` attr), or ``"none"`` for a float symbol.

    The tag encodes the quantization CONFIG (dtypes, weight/activation
    counts, calibration mode) — not the calibration digest — so program
    cache keys separate tiers without recompiling across recalibrations
    of the same config (scales are runtime parameters, not constants
    baked into the executable).  ``serving.CompiledForward`` mixes this
    into its program key; see docs/how_to/quantization.md."""
    try:
        for node, _ in sym._outputs:
            tag = node.attrs.get("__quantized__")
            if tag:
                return tag
    except (AttributeError, TypeError):
        pass
    return "none"


def _select_weights(sym, arg_params, quantize_op_names,
                    excluded_sym_names, min_elems):
    """Pick the weight variables to quantize.

    Candidate selection is per VARIABLE, but eligibility is decided
    over ALL of a variable's consumers: quantizing rewrites the
    variable everywhere, so a weight shared with an excluded node
    (the "protect the stem" knob) or with any non-quantizable
    consumer (tied embedding/output-projection weights) must stay
    float — otherwise the exclusion would be silently bypassed.

    Returns ``(nodes, to_quant, kept)`` — the topo order, a map
    ``var id -> (name, channel axis, is_embedding)``, and a list of
    ``(var name, reason, detail)`` records for weights that LOOKED
    quantizable but stayed float (the emission report's raw material).
    """
    from ..symbol import _topo

    heads = [e[0] for e in sym._outputs]
    nodes = _topo(heads)
    excluded = set(excluded_sym_names)

    uses = {}                       # var id -> list of (node, slot_name)
    for n in nodes:
        if n.is_variable:
            continue
        in_names = n.op.list_inputs(n.params)
        for slot, (child, _) in enumerate(n.inputs):
            if child.is_variable:
                iname = in_names[slot] if slot < len(in_names) else "?"
                uses.setdefault(id(child), []).append((n, iname, child))

    to_quant = {}                   # var id -> (name, axis, is_embedding)
    kept = []                       # (var name, reason, detail)
    for var_id, consumers in uses.items():
        var = consumers[0][2]
        qweight_uses = [
            (node, iname) for node, iname, _ in consumers
            if node.op.name in quantize_op_names and iname == "weight"]
        if not qweight_uses:
            continue                # not a candidate weight at all
        cnames = sorted({node.name for node, _, _ in consumers})
        if any(node.name in excluded for node, _ in qweight_uses):
            kept.append((var.name, "excluded",
                         "consumer excluded via excluded_sym_names "
                         "(%s)" % ", ".join(cnames)))
            continue
        if len(qweight_uses) != len(consumers):
            kept.append((var.name, "shared-nonquant-consumer",
                         "also consumed outside a quantizable weight "
                         "slot (%s)" % ", ".join(cnames)))
            continue
        w = arg_params.get(var.name)
        if w is None:
            continue
        if int(np.prod(w.shape)) < min_elems:
            kept.append((var.name, "min-elems",
                         "%d elems < min_elems=%d (scale metadata "
                         "would not pay for itself)"
                         % (int(np.prod(w.shape)), min_elems)))
            continue
        axes = {_CHANNEL_AXIS[node.op.name] for node, _ in qweight_uses}
        kinds = {node.op.name == "Embedding" for node, _ in qweight_uses}
        if len(axes) != 1 or len(kinds) != 1:
            kept.append((var.name, "mixed-consumers",
                         "shared across ops with different channel "
                         "axes or gather/dense kinds (%s)"
                         % ", ".join(cnames)))
            continue
        to_quant[var_id] = (var.name, axes.pop(), kinds.pop())
    return nodes, to_quant, kept


def _rewrite(sym, nodes, to_quant, arg_params, quantized_dtype,
             compute_dtype, act_plan=None, act_scales=None):
    """Rebuild the graph with dequantize subgraphs spliced in (clone
    all nodes: the caller's symbol must stay untouched).

    ``act_plan``: ``id(consumer node) -> (producer node, out_idx)`` for
    consumers whose data input gets a static fake-quant subgraph;
    ``act_scales``: ``(id(producer), out_idx) -> (scale_name, ndim)``.
    """
    from .. import symbol as _sym
    from ..symbol import Symbol, _Node

    act_plan = act_plan or {}
    act_scales = act_scales or {}
    memo = {}
    emb_vars = {}                   # shared int8/scale table Symbols
    fq_memo = {}                    # (id(prod), idx) -> fake-quant node

    def rebuild_var(node):
        if id(node) in to_quant:
            name, ch_axis, is_emb = to_quant[id(node)]
            if is_emb:
                # the variable disappears: its Embedding consumers are
                # rewritten to gather-then-dequantize below (a
                # variable-level dequant would materialize the whole
                # float table)
                return _Node(None, node.name, attrs=dict(node.attrs))
            # explicit shapes: shape inference cannot invert through
            # the dequant subgraph (the consumer knows its WEIGHT
            # shape, not the shapes of an op's inputs), and they are
            # known here from the float params anyway
            wshape = tuple(arg_params[name].shape)
            sshape = [1] * len(wshape)
            sshape[ch_axis] = wshape[ch_axis]
            sshape = tuple(sshape)
            # every spliced op is explicitly named: auto-generated
            # names carry a process-global counter, which would make
            # repeated quantization of the same model produce
            # different symbol digests (the determinism contract)
            deq = _sym.broadcast_mul(
                _sym.Cast(
                    _sym.Variable(name + "_quant", shape=wshape,
                                  dtype=quantized_dtype),
                    dtype=compute_dtype, name=name + "_dequant_cast"),
                _sym.Variable(name + "_quant_scale", shape=sshape,
                              dtype=compute_dtype),
                name=name + "_dequant")
            return deq._outputs[0][0]
        return _Node(None, node.name, attrs=dict(node.attrs))

    def emb_tables(name):
        """One shared int8 table + per-row scale table per variable —
        every consumer gathers from the same pair."""
        if name not in emb_vars:
            wshape = tuple(arg_params[name].shape)
            emb_vars[name] = (
                _sym.Variable(name + "_quant", shape=wshape,
                              dtype=quantized_dtype),
                _sym.Variable(name + "_quant_scale",
                              shape=(wshape[0], 1),
                              dtype=compute_dtype))
        return emb_vars[name]

    def fake_quant(prod, idx):
        """Static input quantization: round(x / s) clipped to int8,
        dequantized right back in the compute dtype; the int8 hop pins
        activation precision to the calibrated range."""
        key = (id(prod), idx)
        if key not in fq_memo:
            scale_name, ndim = act_scales[key]
            base = scale_name[:-len("_quant_scale")]
            x = Symbol([(memo[id(prod)], idx)])
            s = _sym.Variable(scale_name, shape=(1,) * ndim,
                              dtype=compute_dtype)
            q = _sym.Cast(
                _sym.clip(
                    _sym.round(_sym.broadcast_div(x, s,
                                                  name=base + "_div"),
                               name=base + "_round"),
                    a_min=-127.0, a_max=127.0, name=base + "_clip"),
                dtype=quantized_dtype, name=base + "_int8")
            dq = _sym.broadcast_mul(
                _sym.Cast(q, dtype=compute_dtype,
                          name=base + "_deq_cast"), s,
                name=base + "_dequant")
            fq_memo[key] = dq._outputs[0][0]
        return fq_memo[key]

    for node in nodes:
        if node.is_variable:
            memo[id(node)] = rebuild_var(node)
            continue
        if node.op.name == "Embedding":
            wvar = None
            in_names = node.op.list_inputs(node.params)
            for slot, (child, _) in enumerate(node.inputs):
                if slot < len(in_names) and in_names[slot] == "weight" \
                        and child.is_variable and id(child) in to_quant:
                    wvar = child
            if wvar is not None and to_quant[id(wvar)][2]:
                name = to_quant[id(wvar)][0]
                dnode, didx = node.inputs[0]
                data = Symbol([(memo[id(dnode)], didx)])
                qtab, stab = emb_tables(name)
                p = dict(node.params)
                if "dtype" in p:
                    p["dtype"] = quantized_dtype
                emb_q = _sym.Embedding(
                    data, qtab, name=node.name, **p)
                p_s = dict(p)
                p_s["output_dim"] = 1
                if "dtype" in p_s:
                    p_s["dtype"] = compute_dtype
                emb_s = _sym.Embedding(
                    data, stab, name=node.name + "_scale_rows", **p_s)
                out = _sym.broadcast_mul(
                    _sym.Cast(emb_q, dtype=compute_dtype,
                              name=node.name + "_dequant_cast"),
                    emb_s, name=node.name + "_dequant")
                memo[id(node)] = out._outputs[0][0]
                continue
        inputs = []
        for slot, (child, cidx) in enumerate(node.inputs):
            if slot == 0 and id(node) in act_plan:
                prod, pidx = act_plan[id(node)]
                inputs.append((fake_quant(prod, pidx), 0))
                continue
            inputs.append((memo[id(child)], cidx))
        memo[id(node)] = _Node(
            node.op, node.name, params=dict(node.params),
            attrs=dict(node.attrs), inputs=inputs)

    return Symbol([(memo[id(n)], i) for n, i in sym._outputs])


def _stamp(qsym, quantized_dtype, compute_dtype, n_weights, n_acts,
           mode):
    tag = json.dumps(
        {"dtype": quantized_dtype, "compute": compute_dtype,
         "weights": int(n_weights), "activations": int(n_acts),
         "mode": mode or "weights-only"}, sort_keys=True,
        separators=(",", ":"))
    qsym._set_attr(__quantized__=tag)
    return tag


def quantize_model(sym, arg_params, aux_params=None,
                   quantized_dtype="int8", compute_dtype="float32",
                   quantize_op_names=_DEFAULT_OPS,
                   excluded_sym_names=(), min_elems=1024):
    """Rewrite ``sym`` for weights-only int8 serving.

    Every ``quantize_op_names`` node's weight variable (unless the node
    is in ``excluded_sym_names`` or the weight has fewer than
    ``min_elems`` elements — tiny weights don't pay for their scale
    metadata) is replaced by
    ``broadcast_mul(Cast(W_quant, compute_dtype), W_quant_scale)``;
    binding then stores the weight as int8 on the device and the
    dequantize runs before the consumer.  ``Embedding`` tables instead
    dequantize per gathered row (``take(Wq) * take(scale)``), never
    touching the rows a batch doesn't reference.  ``compute_dtype``
    must match the dtype the caller serves in (``"bfloat16"`` for the
    bf16 tier).

    Returns ``(qsym, qarg_params, aux_params)`` — same contract shape
    as classic MXNet's ``mx.contrib.quantization.quantize_model``.
    """
    nodes, to_quant, _ = _select_weights(
        sym, arg_params, quantize_op_names, excluded_sym_names,
        min_elems)
    if not to_quant:
        raise MXNetError(
            "nothing to quantize: no %s weight >= %d elems found"
            % ("/".join(quantize_op_names), min_elems))

    qsym = _rewrite(sym, nodes, to_quant, arg_params, quantized_dtype,
                    compute_dtype)
    _stamp(qsym, quantized_dtype, compute_dtype, len(to_quant), 0,
           None)
    qargs = quantize_params(
        arg_params, {name: ax for name, ax, _ in to_quant.values()},
        quantized_dtype)
    if compute_dtype != "float32":
        # scales ride the compute dtype so broadcast_mul type-infers
        # cleanly; bf16's 8 mantissa bits match the int8 payload
        for k in list(qargs):
            if k.endswith("_quant_scale"):
                qargs[k] = qargs[k].astype(compute_dtype)
    return qsym, qargs, dict(aux_params or {})


class CalibrationResult(object):
    """What ``calibrate_model`` measured and decided.

    ``report`` is an ``analysis.core.LintReport`` whose findings name
    every quantized tensor AND every op kept float with the reason —
    the emission report.  ``digest`` fingerprints the calibration
    outcome (mode, ranges, scales): bit-identical calibration data and
    seed reproduce it exactly, and the checkpoint manifest stamps it so
    a served model can be traced back to its calibration run."""

    def __init__(self, report, mode, percentile, num_batches,
                 act_ranges, act_scales, weight_axes, config,
                 symbol_digest=None, weight_scale_fps=None):
        self.report = report
        self.mode = mode
        self.percentile = percentile
        self.num_batches = num_batches
        self.act_ranges = act_ranges      # scale var name -> amax
        self.act_scales = act_scales      # scale var name -> scale
        self.weight_axes = weight_axes    # weight name -> channel axis
        self.config = config
        # the payload must pin WHAT was calibrated, not just how: the
        # float symbol digest and a fingerprint of every computed
        # weight-scale tensor.  Without them, two different models
        # calibrated weights-only under the same config collide on one
        # digest and the manifest's provenance stamp says nothing.
        payload = json.dumps(
            {"mode": mode, "percentile": percentile,
             "num_batches": num_batches,
             "symbol": symbol_digest,
             "ranges": {k: float(v)
                        for k, v in sorted(act_ranges.items())},
             "scales": {k: float(v)
                        for k, v in sorted(act_scales.items())},
             "weights": {k: int(v)
                         for k, v in sorted(weight_axes.items())},
             "weight_scales": dict(sorted(
                 (weight_scale_fps or {}).items()))},
            sort_keys=True, separators=(",", ":"))
        self.digest = hashlib.sha1(payload.encode()).hexdigest()

    def to_dict(self):
        return {"mode": self.mode, "percentile": self.percentile,
                "num_batches": self.num_batches, "digest": self.digest,
                "config": dict(self.config),
                "act_scales": {k: float(v)
                               for k, v in sorted(
                                   self.act_scales.items())},
                "findings": [f.to_dict()
                             for f in self.report.findings]}


def calibrate_model(sym, arg_params, aux_params=None, calib_iter=None,
                    num_calib_batches=None, calib_mode=None,
                    percentile=None, quantized_dtype="int8",
                    compute_dtype="float32",
                    quantize_op_names=_DEFAULT_OPS,
                    excluded_sym_names=(), min_elems=1024, ctx=None):
    """Static post-training quantization over a calibration set.

    Runs the FLOAT forward over ``calib_iter`` (any iterator of
    ``DataBatch``; ``num_calib_batches`` caps it), capturing the range
    of every activation feeding a quantized conv/FC — captured at the
    producing node, i.e. billed to that symbol layer's name.  Range
    statistics per
    ``calib_mode``:

      minmax      amax = max |x| over the calibration set (default)
      percentile  amax = max over batches of the per-batch
                  ``percentile`` of |x| (softened against outliers;
                  deterministic, no histogram resolution knob)

    Each captured tensor gets one static scale ``amax / 127`` and the
    emitted symbol quantizes it to int8 inline
    (``round(x/s) -> clip -> int8 -> cast*s`` before the consumer).
    Weights quantize exactly as ``quantize_model``.  Kept
    in the compute dtype, with a Finding each in ``result.report``:
    softmax/BatchNorm/norm ops (numerically sensitive), the output
    head's input activation, integer inputs (Embedding ids), and any
    weight vetoed by sharing/exclusion/size.

    Returns ``(qsym, qarg_params, aux_params, CalibrationResult)``.
    Determinism: same symbol + params + calibration batches + mode give
    bit-identical scales, an identical symbol digest, and an identical
    ``result.digest``.
    """
    from .. import ndarray as nd
    from .. import symbol as _sym
    from ..symbol import Symbol
    from .. import envknobs
    from ..analysis.core import Finding, LintReport, INFO
    from ..serving.compiled import symbol_digest

    if calib_iter is None:
        raise MXNetError("calibrate_model requires calib_iter")
    if calib_mode is None:
        calib_mode = envknobs.get_str("MXTPU_QUANT_MODE", "minmax")
    if calib_mode not in ("minmax", "percentile"):
        raise MXNetError("calib_mode must be minmax|percentile, got %r"
                         % (calib_mode,))
    if percentile is None:
        percentile = envknobs.get_float("MXTPU_QUANT_PERCENTILE", 99.9)
    if not 0.0 < float(percentile) <= 100.0:
        raise MXNetError("percentile must be in (0, 100]")

    nodes, to_quant, kept = _select_weights(
        sym, arg_params, quantize_op_names, excluded_sym_names,
        min_elems)
    if not to_quant:
        raise MXNetError(
            "nothing to quantize: no %s weight >= %d elems found"
            % ("/".join(quantize_op_names), min_elems))

    report = LintReport(model="quant-emit")

    def _add(finding):
        report.extend([finding])

    # ---- choose which activations to calibrate ---------------------
    consumers_of = {}               # id(node) -> [consumer nodes]
    for n in nodes:
        if n.is_variable:
            continue
        for child, _ in n.inputs:
            consumers_of.setdefault(id(child), []).append(n)

    act_plan = {}                   # id(consumer) -> (producer, idx)
    for n in nodes:
        if n.is_variable or n.op.name not in _DENSE_OPS:
            continue
        if n.op.name not in quantize_op_names or \
                n.name in excluded_sym_names:
            continue
        in_names = n.op.list_inputs(n.params)
        wq = any(
            in_names[slot] == "weight" and child.is_variable
            and id(child) in to_quant
            for slot, (child, _) in enumerate(n.inputs)
            if slot < len(in_names))
        if not wq:
            _add(Finding(
                "quant-keep-float", INFO, n.name, n.op.name,
                "input activation kept float: weight not quantized",
                layer=n.name))
            continue
        heads_down = [c.op.name for c in consumers_of.get(id(n), [])]
        if any(h in _HEAD_OPS for h in heads_down):
            _add(Finding(
                "quant-keep-float", INFO, n.name, n.op.name,
                "output head input kept float: logit margins feed the "
                "accuracy gate directly", layer=n.name))
            continue
        act_plan[id(n)] = n.inputs[0]

    # ---- run the float forward, capture ranges ---------------------
    prod_info = {}     # (id(prod), idx) -> dict(sym, name, consumers)
    for nid, (prod, idx) in act_plan.items():
        key = (id(prod), idx)
        info = prod_info.setdefault(
            key, {"sym": Symbol([(prod, idx)]),
                  "name": prod.name, "consumers": []})
        info["consumers"].append(nid)
    node_by_id = {id(n): n for n in nodes}

    amax = {}
    ndims = {}
    seen_batches = 0
    if prod_info:
        keys = sorted(prod_info, key=lambda k: prod_info[k]["name"])
        group = _sym.Group([prod_info[k]["sym"] for k in keys])
        from ..module import Module
        if hasattr(calib_iter, "reset"):
            calib_iter.reset()
        first = None
        for batch in calib_iter:
            first = batch
            break
        if first is None:
            raise MXNetError("calib_iter yielded no batches")
        data_names = [d[0] if isinstance(d, tuple) else d.name
                      for d in getattr(calib_iter, "provide_data", [])]
        if not data_names:
            present = set(arg_params) | set(aux_params or {})
            data_names = [a for a in group.list_arguments()
                          if a not in present]
        mod = Module(group, data_names=data_names, label_names=[],
                     context=ctx)
        mod.bind(data_shapes=[(name, tuple(arr.shape)) for name, arr
                              in zip(data_names, first.data)],
                 for_training=False)
        mod.set_params(arg_params, aux_params or {},
                       allow_missing=False)

        def absorb(batch):
            mod.forward(batch, is_train=False)
            for key, out in zip(keys, mod.get_outputs()):
                arr = out.asnumpy()
                if not np.issubdtype(arr.dtype, np.floating):
                    amax[key] = None          # integer input: skip
                    continue
                if amax.get(key, 0.0) is None:
                    continue
                if calib_mode == "percentile":
                    m = float(np.percentile(np.abs(arr),
                                            float(percentile)))
                else:
                    m = float(np.abs(arr).max())
                amax[key] = max(m, amax.get(key, 0.0))
                ndims[key] = arr.ndim

        absorb(first)
        seen_batches = 1
        for batch in calib_iter:
            if num_calib_batches is not None and \
                    seen_batches >= num_calib_batches:
                break
            absorb(batch)
            seen_batches += 1

    # drop integer/never-seen producers from the plan
    act_scales = {}                 # (id(prod), idx) -> (name, ndim)
    act_scale_vals = {}             # scale var name -> scale value
    act_range_vals = {}             # scale var name -> amax
    for key, info in sorted(prod_info.items(),
                            key=lambda kv: kv[1]["name"]):
        m = amax.get(key)
        consumer_names = ", ".join(
            sorted(node_by_id[nid].name for nid in info["consumers"]))
        if m is None:
            for nid in list(info["consumers"]):
                act_plan.pop(nid, None)
            _add(Finding(
                "quant-keep-float", INFO, info["name"],
                "activation",
                "input kept float: non-float or never observed during "
                "calibration (consumers: %s)" % consumer_names,
                layer=info["name"]))
            continue
        scale_name = info["name"] + "_act_quant_scale"
        scale = np.float32(m / 127.0) if m > 0.0 else np.float32(1.0)
        act_scales[key] = (scale_name, ndims[key])
        act_scale_vals[scale_name] = float(scale)
        act_range_vals[scale_name] = float(m)
        _add(Finding(
            "quant-activation", INFO, info["name"],
            "activation",
            "statically quantized to %s: amax=%.6g scale=%.6g (%s, "
            "consumers: %s)" % (quantized_dtype, m, float(scale),
                                calib_mode, consumer_names),
            layer=info["name"],
            detail={"amax": float(m), "scale": float(scale),
                    "mode": calib_mode, "batches": seen_batches}))

    # ---- emission report: weights + kept-float ops -----------------
    weight_axes = {name: ax for name, ax, _ in to_quant.values()}
    for name, ax, is_emb in sorted(to_quant.values()):
        _add(Finding(
            "quant-weight", INFO, name,
            "Embedding" if is_emb else "weight",
            "quantized to %s (%s, channel axis %d)"
            % (quantized_dtype,
               "per-row scales, dequantized after the gather"
               if is_emb else "per-output-channel scales", ax),
            layer=name))
    for name, reason, detail in kept:
        _add(Finding(
            "quant-keep-float", INFO, name, "weight",
            "weight kept float (%s): %s" % (reason, detail),
            layer=name))
    for n in nodes:
        if not n.is_variable and n.op.name in _SENSITIVE_OPS:
            _add(Finding(
                "quant-keep-float", INFO, n.name, n.op.name,
                "kept in %s: %s" % (compute_dtype,
                                    _SENSITIVE_OPS[n.op.name]),
                layer=n.name))

    # ---- emit ------------------------------------------------------
    qsym = _rewrite(sym, nodes, to_quant, arg_params, quantized_dtype,
                    compute_dtype, act_plan=act_plan,
                    act_scales=act_scales)
    _stamp(qsym, quantized_dtype, compute_dtype, len(to_quant),
           len(act_scale_vals), calib_mode)
    qargs = quantize_params(arg_params, weight_axes, quantized_dtype)
    for scale_name, ndim in act_scales.values():
        qargs[scale_name] = nd.array(
            np.full((1,) * ndim, act_scale_vals[scale_name],
                    dtype=np.float32))
    if compute_dtype != "float32":
        for k in list(qargs):
            if k.endswith("_quant_scale"):
                qargs[k] = qargs[k].astype(compute_dtype)

    config = {"quantized_dtype": quantized_dtype,
              "compute_dtype": compute_dtype,
              "calib_mode": calib_mode,
              "percentile": float(percentile),
              "num_calib_batches": seen_batches,
              "min_elems": int(min_elems),
              "excluded_sym_names": sorted(excluded_sym_names),
              "quantized_weights": sorted(weight_axes),
              "quantized_activations": sorted(act_scale_vals)}
    scale_fps = {
        k: hashlib.sha1(np.ascontiguousarray(
            qargs[k + "_quant_scale"].asnumpy()).tobytes()).hexdigest()
        for k in weight_axes}
    result = CalibrationResult(
        report, calib_mode, float(percentile), seen_batches,
        act_range_vals, act_scale_vals, weight_axes, config,
        symbol_digest=symbol_digest(sym),
        weight_scale_fps=scale_fps)
    return qsym, qargs, dict(aux_params or {}), result


def evaluate_gate(ref_probs, q_probs, labels, min_agreement,
                  max_top1_delta):
    """The accuracy gate: argmax agreement of ``q_probs`` with the float
    model's ``ref_probs`` on a holdout (at least ``min_agreement``), and
    where ``labels`` are known a top-1 accuracy drop of at most
    ``max_top1_delta`` points.  Returns the record, with ``passed``."""
    ref_top = np.asarray(ref_probs).argmax(1)
    q_top = np.asarray(q_probs).argmax(1)
    agreement = float((ref_top == q_top).mean())
    record = {"argmax_agreement": round(agreement, 6),
              "holdout_examples": int(len(ref_top)),
              "thresholds": {"min_agreement": float(min_agreement),
                             "max_top1_delta_pt": float(max_top1_delta)}}
    passed = agreement >= float(min_agreement)
    if labels is not None:
        labels = np.asarray(labels)
        top1_f32 = float((ref_top == labels).mean())
        top1_q = float((q_top == labels).mean())
        delta_pt = (top1_f32 - top1_q) * 100.0
        record.update({"top1_f32": round(top1_f32, 6),
                       "top1_quant": round(top1_q, 6),
                       "top1_delta_pt": round(delta_pt, 4)})
        passed = passed and delta_pt <= float(max_top1_delta)
    record["passed"] = bool(passed)
    return record
