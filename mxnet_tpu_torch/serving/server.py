"""Continuous-batching model server over shape buckets captured as CUDA
graphs (the port of ``mxnet_tpu/serving/server.py``).

The deploy surface of the reference is the predict-only C API — one
request, one forward.  A card earns its keep at batch 16-32, so a server
fronting many concurrent clients must coalesce requests onto
accelerator-sized batches (the TensorFlow serving design) while never
paying set-up work on the hot path (TVM's pre-compiled-variants
insight).  Both halves live here:

* **continuous batching** — ``submit()`` enqueues a request and returns
  a :class:`ServeFuture`; a scheduler thread drains the queue into the
  largest admissible batch each cycle (dispatch when the pending rows
  reach ``cap`` or the oldest request has waited ``max_wait_us``),
  slices the batched outputs back per request, and completes futures.
* **shape buckets** — the batch is padded to the next registered
  bucket size (default 1/4/8/16/32); every bucket of every model is
  registered at ``start()`` through the shared
  :class:`~.compiled.CompiledForward` cache — on the card, captured once
  as a CUDA graph per (tenant, bucket), all graphs of the device in one
  memory pool, and replayed for every batch — so steady state runs with
  **zero retraces** (``assert_no_retrace()``).

Weights live on the device once per model and every bucket graph of the
model reads them in place — multi-tenant hosting is just ``add_model``
called N times on one server (N symbols, one scheduler, one
compiled-forward cache).  The server runs on the context it was given
(``ctx=``), by default the current one (``gpu(0)`` unless a
``with mt.cpu():`` scope says otherwise).  Results are host tensors
(CPU ``torch.Tensor`` in the output's dtype), the counterpart of the
JAX package's numpy outputs: on the card only a batch's real rows are
copied out, into pinned memory, together with one finiteness flag per
row computed on the device.  Fault handling: the ``MXTPU_FAULTS`` DSL
(``faults.py``) can mark requests slow (``slow_request@request=K``) or
poisoned (``poison_request@request=K``); a poisoned payload fails ITS
OWN future via the per-request output-finiteness check while the rest
of the batch completes, and expired requests fail with a timeout before
ever entering a batch.

**Overload protection / graceful degradation** (the robustness mirror
of the throughput story — a serving layer is judged by its degradation
curve, not its peak):

* **admission control** — per-model queues are bounded at
  ``queue_cap`` rows; past it ``submit()`` sheds per ``shed_policy``:
  ``reject`` raises :class:`ServeOverload` immediately (fail fast, the
  client retries elsewhere), ``block`` applies backpressure — the
  caller waits on the queue up to the request deadline, then
  :class:`ServeOverload`.
* **deadline-aware scheduling** — a queued request whose remaining
  deadline cannot cover the model's EWMA batch latency is shed at
  ``_take_batch`` time (``shed_deadline``) instead of burning a
  dispatch it will miss anyway; expiry is re-checked after compute so
  a late result fails its future (``expired_after_dispatch``) rather
  than pretending to be on time; :meth:`ServeFuture.cancel` removes a
  still-queued request and frees its rows.
* **per-model circuit breaker** — ``breaker_k`` consecutive batch
  failures open the breaker: that model's submits fail immediately
  with :class:`ServeUnavailable` (other tenants unaffected) until a
  cool-down, after which one half-open probe batch decides: success
  closes, failure re-opens.
* **scheduler supervision** — an uncaught scheduler exception fails
  EVERY pending future and flips the server to rejecting (a crash is
  loud, never a silent hang); ``stop(drain_s=...)`` serves already-
  queued work up to a deadline before failing the remainder; multi-
  tenant dispatch rotates round-robin across models so one hot tenant
  cannot starve the rest.

Knobs (constructor arg wins over ``MXTPU_SERVE_*`` env):

======================  ==============================  =================
constructor              env                             default
======================  ==============================  =================
``buckets``             ``MXTPU_SERVE_BUCKETS``         ``1,4,8,16,32``
``max_wait_us``         ``MXTPU_SERVE_MAX_WAIT_US``     ``2000``
``cap``                 ``MXTPU_SERVE_CAP``             largest bucket
``timeout_ms``          ``MXTPU_SERVE_TIMEOUT_MS``      ``10000`` (0 = off)
``validate``            ``MXTPU_SERVE_VALIDATE``        ``1`` (finiteness)
``queue_cap``           ``MXTPU_SERVE_QUEUE_CAP``       ``4096`` rows (0 = off)
``shed_policy``         ``MXTPU_SERVE_SHED_POLICY``     ``reject`` | ``block``
``breaker_k``           ``MXTPU_SERVE_BREAKER_K``       ``5`` (0 = off)
``breaker_cooldown_ms`` ``MXTPU_SERVE_BREAKER_COOLDOWN_MS``  ``1000``
``stop(drain_s=)``      ``MXTPU_SERVE_DRAIN_S``         ``0`` (fail tail)
======================  ==============================  =================

Waiting for later slices, each raising :class:`MXNetError` that names
it: ``mesh=`` (several devices), ``plan=`` / ``MXTPU_TUNE_PLAN`` (tune
plans) and ``lint()`` (the static analyses).  ``precision="int8"``
admits only tenants that ``contrib.quantization`` rewrote (their int8
weights held at 1 byte an element, counted in
``weight_bytes_on_device``), ``float32``/``bfloat16`` refuse them, and
``auto`` admits both.  ``predicted_peak_bytes`` stays 0, so
``mem_budget`` gates on weight bytes alone — the JAX package's own
fallback when its liveness analysis cannot price a tenant.

``docs/how_to/serving.md`` walks through the JAX package's design, which
this module keeps.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base import Context, MXNetError, current_context
from ..contrib.quantization import quant_tag
from ..convert import _tensor
from ..ndarray import NDArray
from .. import _tsan
from .. import envknobs as _envknobs
from .. import faults as _faults
from .. import obs as _obs
from .compiled import compiled_forward, infer_input_dtypes

__all__ = ["ModelServer", "ServeFuture", "ServeTimeout", "ServeError",
           "ServeOverload", "ServeUnavailable", "ServeCancelled"]


class ServeError(MXNetError):
    """A request failed inside the server (poisoned payload, shutdown)."""


class ServeTimeout(ServeError):
    """A request's deadline expired before it was served."""


class ServeOverload(ServeError):
    """Shed by admission control: the model's queue is at ``queue_cap``
    rows (``reject`` policy, or the ``block`` backpressure wait outlived
    the request deadline).  Fails FAST — an overloaded server must say
    no in microseconds, not let p99 grow without bound."""


class ServeUnavailable(ServeError):
    """The model (circuit breaker open) or the whole server (scheduler
    crashed, draining) is refusing new work."""


class ServeCancelled(ServeError):
    """The request was cancelled while still queued (explicit
    :meth:`ServeFuture.cancel`, or a ``result``/``exception`` wait that
    timed out and reclaimed the queued rows)."""


class ServeFuture:
    """Completion handle for one submitted request."""

    __slots__ = ("_done", "_result", "_exc", "t_submit", "t_done",
                 "_cancel_cb", "_span")

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc = None
        self.t_submit = time.perf_counter()
        self.t_done = None
        self._cancel_cb = None
        self._span = None       # serve.request root (MXTPU_OBS=1 only)

    def _set_result(self, outs):
        self._result = outs
        self.t_done = time.perf_counter()
        # a settled future cannot be cancelled: dropping the callback
        # breaks the future <-> request cycle, so a result (a pinned
        # block of GPT-2 logits, say) is freed when its holder drops it,
        # not at the next cyclic collection
        self._cancel_cb = None
        if self._span is not None:
            # EVERY completion path funnels here, so the request's span
            # tree closes exactly when its future does (the root sweeps
            # any still-open child, e.g. a shed request's queue span)
            self._span.finish(t=self.t_done)
        self._done.set()

    def _set_exception(self, exc):
        self._exc = exc
        self.t_done = time.perf_counter()
        self._cancel_cb = None
        if self._span is not None:
            self._span.attrs["error"] = type(exc).__name__
            self._span.finish(t=self.t_done)
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Remove the request from its queue if it has not been
        dispatched yet.  Returns True when the request was still queued
        — its rows are freed from the model's ``pending`` budget and
        this future fails with :class:`ServeCancelled`.  Returns False
        when the request already completed or already entered a batch
        (an in-flight batch is never torn apart; the result simply
        arrives)."""
        if self._done.is_set() or self._cancel_cb is None:
            return False
        return self._cancel_cb()

    def result(self, timeout: Optional[float] = None) -> List[torch.Tensor]:
        """Block for the outputs (one host tensor per graph output,
        leading dim = this request's row count).  Raises what the request
        raised.  A wait that times out CANCELS the request if it is
        still queued — an abandoned wait must not keep consuming
        scheduler work and queue rows."""
        if not self._done.wait(timeout):
            self.cancel()
            raise ServeTimeout("request not completed within %ss" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            self.cancel()
            raise ServeTimeout("request not completed within %ss" % timeout)
        return self._exc

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


class _Request:
    __slots__ = ("rid", "inputs", "n", "future", "t_in", "deadline",
                 "slow", "poisoned", "span", "queue_span")

    def __init__(self, rid, inputs, n, deadline):
        self.rid = rid
        self.inputs = inputs
        self.n = n
        self.future = ServeFuture()
        self.t_in = time.perf_counter()
        self.deadline = None if deadline is None else self.t_in + deadline
        self.slow = _faults.hit("slow_request", request=rid)
        self.poisoned = _faults.hit("poison_request", request=rid)
        self.span = None        # serve.request / serve.queue spans
        self.queue_span = None  # (MXTPU_OBS=1 only; see submit())


class _Model:
    """One tenant: symbol + device-resident weights + shared compiled
    forward + per-model request queue."""

    __slots__ = ("name", "symbol", "cf", "params", "aux", "example_shapes",
                 "label_trailing", "input_dtypes", "queue", "pending",
                 "n_outputs", "breaker", "consec_failures", "opened_at",
                 "batches", "sheds_since_batch", "lat_hist",
                 "weight_bytes_on_device", "quant",
                 "predicted_peak_bytes", "pad_ctrs", "labels", "graphs")

    def __init__(self, name, symbol, cf, params, aux, example_shapes,
                 label_trailing, input_dtypes, n_outputs):
        self.name = name
        self.symbol = symbol
        self.cf = cf
        self.params = params
        self.aux = aux
        self.example_shapes = example_shapes    # data input -> trailing dims
        self.label_trailing = label_trailing    # label input -> trailing dims
        self.input_dtypes = input_dtypes
        self.queue = collections.deque()
        # queued rows, maintained under _cond — a full-queue scan per
        # scheduler wakeup would make draining a backlog quadratic
        self.pending = 0
        self.n_outputs = n_outputs
        # circuit breaker (all mutated under the server's _cond):
        # closed -> open after breaker_k consecutive batch failures,
        # open -> half_open after the cool-down admits one probe,
        # half_open -> closed on probe success / open on probe failure
        self.breaker = "closed"
        self.consec_failures = 0
        self.opened_at = None
        self.batches = 0                        # dispatched for this model
        # static-analyzer footprint: weights + worst-bucket activation
        # peak per chip (0 when the liveness walk could not price it);
        # set by add_model, read by the admission ledger and stats()
        self.predicted_peak_bytes = 0
        self.pad_ctrs = None    # per-model rows_real/rows_padded counters
        self.labels: Dict[int, Dict] = {}   # padded rows -> zero labels
        # this tenant's CUDA graphs, one per bucket (captured at start(),
        # dropped at stop()): they die with the tenant, not with the
        # shared compiled forward
        self.graphs: Dict = {}
        # EWMA-shed escape hatch: consecutive sheds since the last
        # dispatched batch.  An anomalous slow batch can inflate the
        # EWMA past every deadline; without a probe, no batch would
        # ever run again to decay it (permanent 100% shed).
        self.sheds_since_batch = 0


def _host_tensor(value) -> torch.Tensor:
    """A request input as a host tensor (a port NDArray, a tensor, or
    anything numpy takes, numpy's bfloat16 included)."""
    if isinstance(value, NDArray):
        value = value.data
    elif not isinstance(value, torch.Tensor):
        value = _tensor(np.asarray(value))
    return value.cpu()


def _env_int(name, default):
    # the registry's typed getter: same "%s=%r is not an integer"
    # error shape, plus the knob is a declared name validate_environ
    # can vouch for
    return _envknobs.get_int(name, default)


class ModelServer:
    """Thread-safe continuous-batching server over one or more models."""

    # after this many consecutive EWMA deadline-sheds with no batch
    # dispatched, one request goes through as a latency probe (see
    # _take_batch) — the anti-latch bound on predictive shedding
    _SHED_PROBE_EVERY = 8

    def __init__(self, buckets: Optional[Sequence[int]] = None,
                 max_wait_us: Optional[int] = None,
                 cap: Optional[int] = None,
                 timeout_ms: Optional[int] = None,
                 validate: Optional[bool] = None,
                 mesh=None,
                 queue_cap: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 breaker_k: Optional[int] = None,
                 breaker_cooldown_ms: Optional[int] = None,
                 precision: Optional[str] = None,
                 mem_budget: Optional[int] = None,
                 pace_rps: Optional[float] = None,
                 plan=None, ctx: Optional[Context] = None):
        if mesh is not None:
            raise MXNetError("ModelServer(mesh=) waits for the port's mesh "
                             "and KVStore slice (ROADMAP queue A item 5)")
        if plan is not None or _envknobs.is_set("MXTPU_TUNE_PLAN"):
            raise MXNetError("tune plans (plan=, MXTPU_TUNE_PLAN) wait for "
                             "the port's tuneplan.py (ROADMAP queue A "
                             "item 9)")
        self.device = Context(ctx or current_context()).torch_device()
        if buckets is None:
            if _envknobs.is_set("MXTPU_SERVE_BUCKETS"):
                buckets = [int(b) for b in
                           os.environ["MXTPU_SERVE_BUCKETS"].split(",")
                           if b]
            else:
                buckets = [1, 4, 8, 16, 32]
        self.buckets = sorted(set(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("buckets must be positive ints, got %s"
                             % (buckets,))
        if max_wait_us is None:
            max_wait_us = _env_int("MXTPU_SERVE_MAX_WAIT_US", 2000)
        self.max_wait_s = max_wait_us / 1e6
        self.cap = int(cap) if cap is not None \
            else _env_int("MXTPU_SERVE_CAP", self.buckets[-1])
        timeout_ms = timeout_ms if timeout_ms is not None \
            else _env_int("MXTPU_SERVE_TIMEOUT_MS", 10000)
        self.timeout_s = (timeout_ms / 1e3) if timeout_ms else None
        if validate is None:
            validate = os.environ.get("MXTPU_SERVE_VALIDATE", "1") != "0"
        self.validate = bool(validate)
        # admission control: queued rows per model are bounded at
        # queue_cap (0 = unbounded, the pre-overload-story behavior);
        # past it submit() sheds per shed_policy
        self.queue_cap = int(queue_cap) if queue_cap is not None \
            else _env_int("MXTPU_SERVE_QUEUE_CAP", 4096)
        if shed_policy is None:
            shed_policy = _envknobs.get_str("MXTPU_SERVE_SHED_POLICY",
                                            "reject")
        if shed_policy not in ("reject", "block"):
            raise MXNetError("shed_policy %r is not 'reject' or 'block'"
                             % (shed_policy,))
        self.shed_policy = shed_policy
        # circuit breaker: K consecutive whole-batch failures open it
        # (0 disables); one probe batch is admitted after the cool-down
        self.breaker_k = int(breaker_k) if breaker_k is not None \
            else _env_int("MXTPU_SERVE_BREAKER_K", 5)
        self.breaker_cooldown_s = (
            breaker_cooldown_ms if breaker_cooldown_ms is not None
            else _env_int("MXTPU_SERVE_BREAKER_COOLDOWN_MS", 1000)) / 1e3
        # precision tier contract: "auto" admits anything; "int8"
        # requires every tenant symbol to be quantized (quant_tag !=
        # none); "float32"/"bfloat16" reject quantized tenants
        if precision is None:
            precision = _envknobs.get_str("MXTPU_SERVE_PRECISION", "auto")
        if precision not in ("auto", "float32", "bfloat16", "int8"):
            raise MXNetError("precision %r is not auto|float32|bfloat16"
                             "|int8" % (precision,))
        self.precision = precision
        # memory-aware admission (opt-in): per-device byte budget the
        # tenants' footprints must fit in.  The liveness analyzer that
        # prices a bucket's activation peak waits for the port's static
        # analyses, so the footprint is the weight bytes (the JAX
        # package's fallback when the analysis fails).  0 disarms.
        self.mem_budget = int(mem_budget) if mem_budget is not None \
            else _env_int("MXTPU_SERVE_MEM_BUDGET", 0)
        # service pacing (rows/s, 0 = off): after each dispatched batch
        # the scheduler sleeps out the remainder of rows/pace_rps.  This
        # emulates a fixed per-replica device capacity on the CPU, where
        # in-process replicas share the host cores.  The sleep happens
        # outside _cond, so admission and draining proceed normally.
        self.pace_rps = float(pace_rps) if pace_rps is not None \
            else float(os.environ.get("MXTPU_SERVE_PACE_RPS", "0") or 0)
        self._models: Dict[str, _Model] = {}
        self._cond = _tsan.condition("serving.ModelServer._cond")
        self._thread = None
        self._stop = False
        self._started = False
        self._draining = False      # stop(drain_s): serve queue, no admits
        self._crashed = None        # scheduler supervision: the exception
        self._rr = 0                # round-robin rotation across models
        self._rid = 0
        # counters (all mutated under _cond; VALUES live in the metrics
        # registry — obs.CounterDict keeps the `_stats[k] += 1` spelling
        # and the dict(self._stats) snapshot shape while one
        # obs.snapshot() per process scrapes every server's numbers,
        # docs/how_to/observability.md)
        self._obs_scope = _obs.REGISTRY.scope("serving.server")
        self._stats = _obs.CounterDict(self._obs_scope, {
            "requests": 0, "completed": 0, "failed": 0,
            "timeouts": 0, "batches": 0, "rows_real": 0,
            "rows_padded": 0,
            # overload / degradation accounting
            "rejected_overload": 0,      # queue_cap sheds
            "rejected_breaker": 0,       # breaker-open refusals
            "shed_deadline": 0,          # EWMA-predicted misses
            "expired_after_dispatch": 0,  # late results
            "cancelled": 0,              # ServeFuture.cancel
            "batch_failures": 0,         # whole-batch errors
            # bucket programs loaded from a persisted program cache at
            # start(); the port has none yet, so this stays 0
            "warmup_loaded": 0})
        self._occupancy: Dict[int, List[int]] = {}   # bucket -> [batches, rows]

    # ------------------------------------------------------------------
    def _placed(self, value) -> torch.Tensor:
        """One-time weight placement on the server's device: a port
        NDArray, a tensor or an array (numpy's bfloat16 included), in
        its own dtype."""
        if isinstance(value, NDArray):
            value = value.data
        elif not isinstance(value, torch.Tensor):
            value = _tensor(value)
        return value.to(self.device)

    def add_model(self, name: str, symbol, arg_params: Dict,
                  aux_params: Optional[Dict] = None,
                  input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                  input_dtypes: Optional[Dict] = None) -> None:
        """Register a tenant.  ``input_shapes`` maps each data input to
        its PER-EXAMPLE shape (no batch dim); label arguments are
        auto-detected and zero-filled per bucket.  ``input_dtypes``
        defaults to what ``infer_type`` derives from the param dtypes
        (so bf16/int8 checkpoints serve in their own dtype)."""
        if self._started:
            raise MXNetError("add_model before start() (bucket compiles "
                             "happen at server start)")
        if name in self._models:
            raise MXNetError("model %r already registered" % name)
        if not input_shapes:
            raise MXNetError("input_shapes (per-example, no batch dim) "
                             "required")
        aux_params = aux_params or {}
        example_shapes = {k: tuple(v) for k, v in input_shapes.items()}

        arg_names = symbol.list_arguments()
        param_names = [n for n in arg_names
                       if n not in example_shapes and n in arg_params]
        label_names = [n for n in arg_names
                       if n not in example_shapes and n not in arg_params]
        bad = [n for n in label_names if not n.endswith("label")]
        if bad:
            raise MXNetError("arguments %s are neither declared inputs, "
                             "loaded params, nor *label inputs" % bad)

        # shape bookkeeping at a reference batch: label trailing dims,
        # batch-major output check (the slicer hands rows back per
        # request — a reduced head would be silently mis-split)
        ref_b = 2
        ref_shapes = {n: (ref_b,) + s for n, s in example_shapes.items()}
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**ref_shapes)
        shape_of = dict(zip(arg_names, arg_shapes))
        label_trailing = {}
        for n in label_names:
            s = shape_of[n]
            if not s or s[0] != ref_b:
                raise MXNetError("label input %r is not batch-major "
                                 "(shape %s)" % (n, s))
            label_trailing[n] = tuple(s[1:])
        for oname, oshape in zip(symbol.list_outputs(), out_shapes or []):
            if not oshape or oshape[0] != ref_b:
                raise MXNetError(
                    "output %r has shape %s — the request slicer needs "
                    "batch-major outputs (reduced heads are not "
                    "servable)" % (oname, tuple(oshape or ())))

        params = {n: self._placed(arg_params[n]) for n in param_names}
        missing = [n for n in arg_names
                   if n not in example_shapes and n not in params
                   and n not in label_names]
        if missing:
            raise MXNetError("params %s missing from arg_params" % missing)
        aux_names = symbol.list_auxiliary_states()
        aux = {}
        for n, s in zip(aux_names, aux_shapes):
            aux[n] = self._placed(aux_params[n]) if n in aux_params \
                else torch.zeros(s, dtype=torch.float32, device=self.device)

        # input dtypes: declared > back-inferred from param dtypes > f32
        # (the SAME rule the Predictor binds with — shared helper)
        dtypes = infer_input_dtypes(
            symbol, params, list(example_shapes) + label_names,
            declared=input_dtypes)

        # precision-tier admission: the knob is only as real as its
        # enforcement — an int8 tier must not silently serve a float
        # checkpoint (and vice versa)
        tag = quant_tag(symbol)
        if self.precision == "int8" and tag == "none":
            raise MXNetError(
                "server precision tier is int8 but model %r is not "
                "quantized (contrib.quantization.quantize_model or "
                "calibrate_model first)" % name)
        if self.precision in ("float32", "bfloat16") and tag != "none":
            raise MXNetError(
                "server precision tier is %s but model %r carries a "
                "quantized symbol (%s)" % (self.precision, name, tag))

        cf = compiled_forward(
            symbol, list(example_shapes) + label_names,
            platform=self.device.type)
        m = _Model(
            name, symbol, cf, params, aux, example_shapes, label_trailing,
            dtypes, len(symbol.list_outputs()))
        # device bytes actually held by this tenant's weights — int8
        # tables report 1 byte/elem here; a post-bind upcast would show
        # up as a 4x jump in stats() (the regression this field exists
        # to catch)
        m.weight_bytes_on_device = int(
            sum(v.numel() * v.element_size() for v in params.values())
            + sum(v.numel() * v.element_size() for v in aux.values()))
        m.quant = tag
        # per-model completed-request latency histogram (fixed buckets;
        # stats() reports p50/p95/p99 beside the EWMA — a histogram
        # survives the burst the EWMA smooths away)
        m.lat_hist = _obs.REGISTRY.histogram(
            "%s.%s.latency_ms" % (self._obs_scope, name))
        # per-model pad accounting (registry-backed like the server
        # counters): rows dispatched for THIS tenant vs the rows it
        # actually asked for — the bucket-ladder fit per model, where
        # the server-wide padding_frac averages tenants together
        m.pad_ctrs = _obs.CounterDict(
            "%s.%s" % (self._obs_scope, name),
            {"rows_real": 0, "rows_padded": 0})

        # memory footprint: the liveness analyzer that prices the worst
        # bucket's activation peak waits for the port's static analyses,
        # so predicted_peak_bytes stays 0 and the weights gate admission
        # (the JAX package's fallback when its analysis fails)
        worst = self.buckets[-1]
        m.predicted_peak_bytes = 0
        if self.mem_budget:
            demand = m.predicted_peak_bytes or m.weight_bytes_on_device
            held = sum((mm.predicted_peak_bytes
                        or mm.weight_bytes_on_device)
                       for mm in self._models.values())
            if held + demand > self.mem_budget:
                raise MXNetError(
                    "model %r refused: predicted footprint %.1f MB/device "
                    "(weights + worst-bucket b%d activation peak) on top "
                    "of %.1f MB already admitted exceeds the %.1f MB "
                    "serve memory budget (MXTPU_SERVE_MEM_BUDGET)"
                    % (name, demand / 1e6, worst, held / 1e6,
                       self.mem_budget / 1e6))
        self._models[name] = m

    # ------------------------------------------------------------------
    def start(self) -> "ModelServer":
        """Register every (model, bucket) pair — on the card, one CUDA
        graph each, captured here — then start the scheduler.  After
        this returns, steady-state serving never retraces
        (``assert_no_retrace``)."""
        if self._started:
            return self
        if not self._models:
            raise MXNetError("add_model first")
        for m in self._models.values():
            for b in self.buckets:
                shapes = self._bucket_shapes(m, b)
                m.cf.aot_compile(m.params, m.aux, shapes, m.input_dtypes,
                                 device=self.device, graphs=m.graphs)
                # one zero-batch execution per bucket (on the card, the
                # graph's first replay and a copy-out of all its rows as
                # one request, so the pinned host block of a request of
                # that many rows is allocated here and cached), so its
                # first-call costs never land on the first live request
                feed = {n: torch.zeros(s, dtype=m.input_dtypes[n],
                                       device=self.device)
                        for n, s in shapes.items()}
                done = m.cf.run(m.params, m.aux, feed, device=self.device,
                                graphs=m.graphs,
                                take=lambda o, b=b: self._copy_out(o, [b])[2])
                if done is not None:
                    done.synchronize()
        self._stop = False
        self._crashed = None    # a stop()/start() restart gets a fresh
        self._draining = False  # scheduler; stale crash/drain state
        self._rr = 0            # must not keep rejecting forever
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-serve-sched",
                                        daemon=True)
        self._started = True
        self._thread.start()
        return self

    def _bucket_shapes(self, m: _Model, b: int) -> Dict[str, tuple]:
        shapes = {n: (b,) + s for n, s in m.example_shapes.items()}
        shapes.update({n: (b,) + s for n, s in m.label_trailing.items()})
        return shapes

    def stop(self, drain_s: Optional[float] = None) -> None:
        """Stop the server.  With ``drain_s`` > 0 (default from
        ``MXTPU_SERVE_DRAIN_S``), the door closes to NEW submits first
        (``ServeUnavailable``) while the scheduler keeps serving the
        already-queued work — dispatching immediately, not waiting out
        coalescing windows — up to the drain deadline; whatever is
        still queued past it fails with ``ServeError``."""
        if drain_s is None:
            try:
                drain_s = float(
                    os.environ.get("MXTPU_SERVE_DRAIN_S", "") or 0.0)
            except ValueError:
                raise MXNetError("MXTPU_SERVE_DRAIN_S=%r is not a number"
                                 % os.environ["MXTPU_SERVE_DRAIN_S"]) \
                    from None
        if drain_s > 0 and self._thread is not None:
            deadline = time.perf_counter() + drain_s
            with self._cond:
                self._draining = True
                self._cond.notify_all()
                while self._crashed is None \
                        and any(m.queue for m in self._models.values()):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=min(left, 0.05))
        with self._cond:
            self._stop = True
            self._draining = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # drain + close the door under ONE lock acquisition: a submit
        # racing stop() either lands before the drain (and is failed
        # here) or sees _started False and raises — no request can slip
        # in after the drain and hang its future forever
        leftovers = []
        with self._cond:
            for m in self._models.values():
                while m.queue:
                    leftovers.append(m.queue.popleft())
                m.pending = 0
                # a stopped server holds no graph (nor its share of the
                # memory pool); start() captures again
                m.graphs.clear()
            self._started = False
            self._draining = False
        for r in leftovers:
            r.future._set_exception(ServeError("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------
    def submit(self, inputs: Optional[Dict] = None, model: Optional[str] = None,
               **kw) -> ServeFuture:
        """Enqueue one request; returns its :class:`ServeFuture`.

        Each input is either one example (exactly the per-example
        shape) or a stack of them (leading request-row dim); all inputs
        of a request must agree on the row count."""
        m = self._resolve(model)
        inputs = dict(inputs or {}, **kw)
        arrs, n = {}, None
        for iname, trailing in m.example_shapes.items():
            if iname not in inputs:
                raise MXNetError("request missing input %r" % iname)
            a = _host_tensor(inputs[iname])
            if tuple(a.shape) == trailing:
                a = a[None]
            elif a.ndim != len(trailing) + 1 \
                    or tuple(a.shape[1:]) != trailing:
                raise MXNetError(
                    "input %r shape %s matches neither the per-example "
                    "shape %s nor (n,)+%s"
                    % (iname, a.shape, trailing, trailing))
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise MXNetError("request inputs disagree on row count "
                                 "(%d vs %d for %r)" % (n, a.shape[0], iname))
            # cast HERE, once, to the bound dtype — the batch assembler
            # concatenates like-dtype parts with no further copies
            arrs[iname] = a.to(dtype=m.input_dtypes[iname]).contiguous()
        extra = set(inputs) - set(m.example_shapes)
        if extra:
            raise MXNetError("unknown inputs %s for model %r"
                             % (sorted(extra), m.name))
        # the request's deadline budget starts at ADMISSION, not at
        # enqueue: a block-policy wait spends from the same budget, so
        # end-to-end latency can never reach 2x timeout_s
        t_admit = time.perf_counter()
        with self._cond:
            # started-check under the lock: see stop() — the enqueue and
            # the shutdown drain are serialized, so a future either gets
            # served, failed by the drain, or refused here
            self._check_admissible(m)
            if self.queue_cap and n > self.queue_cap:
                # can NEVER fit, whatever drains — reject up front under
                # either policy (block would otherwise wait for space
                # that cannot exist)
                self._stats["rejected_overload"] += 1
                raise ServeOverload(
                    "request (%d rows) exceeds the per-model queue cap "
                    "(%d rows) — it can never be admitted; raise "
                    "MXTPU_SERVE_QUEUE_CAP or split the request"
                    % (n, self.queue_cap))
            if self.queue_cap and m.pending + n > self.queue_cap:
                if self.shed_policy == "reject":
                    self._stats["rejected_overload"] += 1
                    raise ServeOverload(
                        "model %r queue is at %d/%d rows — request (%d "
                        "rows) shed (policy=reject; see MXTPU_SERVE_"
                        "QUEUE_CAP / MXTPU_SERVE_SHED_POLICY)"
                        % (m.name, m.pending, self.queue_cap, n))
                # block policy: backpressure — wait for queue space up
                # to the request deadline (condition wait releases the
                # lock, so the scheduler can drain meanwhile)
                wait_deadline = None if self.timeout_s is None \
                    else t_admit + self.timeout_s
                while m.pending + n > self.queue_cap:
                    left = None if wait_deadline is None \
                        else wait_deadline - time.perf_counter()
                    if left is not None and left <= 0:
                        self._stats["rejected_overload"] += 1
                        raise ServeOverload(
                            "model %r queue still at %d/%d rows after "
                            "blocking %.0f ms (policy=block)"
                            % (m.name, m.pending, self.queue_cap,
                               self.timeout_s * 1e3))
                    self._cond.wait(timeout=0.05 if left is None
                                    else min(left, 0.05))
                    self._check_admissible(m)
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.queue")
                _tsan.note_write("serving.ModelServer.stats")
            self._rid += 1
            remaining = None if self.timeout_s is None else max(
                0.0, t_admit + self.timeout_s - time.perf_counter())
            req = _Request(self._rid, arrs, n, remaining)
            req.future._cancel_cb = \
                lambda _m=m, _r=req: self._cancel(_m, _r)
            if _obs.OBS:
                # the request's span tree roots HERE, while the request
                # is still invisible to the scheduler (we hold _cond):
                # root = the whole submit→complete lifecycle (closed by
                # whichever path completes the future), queue = enqueue
                # →dispatch (closed by _run_batch, or swept by the root
                # on a shed/timeout).  Both backdated to t_in so the
                # segments tile the measured end-to-end latency.
                corr = "r%d" % req.rid
                root = _obs.span("serve.request", corr=corr, parent=None,
                                 attrs={"model": m.name, "rows": req.n})
                root.t0 = req.t_in
                qs = _obs.span("serve.queue", corr=corr, parent=root)
                qs.t0 = req.t_in
                req.span, req.queue_span = root, qs
                req.future._span = root
            m.queue.append(req)
            m.pending += n
            self._stats["requests"] += 1
            self._cond.notify_all()
        return req.future

    def _check_admissible(self, m: _Model) -> None:
        """Shutdown / crash / breaker gate, called under ``_cond``."""
        if not self._started or self._stop:
            raise MXNetError("server not started")
        if self._crashed is not None:
            raise ServeUnavailable(
                "server is rejecting requests: scheduler crashed (%s)"
                % self._crashed)
        if self._draining:
            raise ServeUnavailable("server is draining (stop(drain_s))")
        if self.breaker_k and m.breaker == "open":
            now = time.perf_counter()
            if m.opened_at is not None \
                    and now - m.opened_at >= self.breaker_cooldown_s:
                # cool-down elapsed: admit this request as the half-open
                # probe — its batch decides closed vs re-opened
                m.breaker = "half_open"
            else:
                self._stats["rejected_breaker"] += 1
                raise ServeUnavailable(
                    "model %r unavailable: circuit breaker open (%d "
                    "consecutive batch failures; probe in %.0f ms)"
                    % (m.name, m.consec_failures,
                       max(0.0, self.breaker_cooldown_s
                           - (now - (m.opened_at or now))) * 1e3))

    def _cancel(self, m: _Model, req: _Request) -> bool:
        """Back half of :meth:`ServeFuture.cancel`: remove ``req`` from
        its queue if still there, free its rows, fail its future."""
        with self._cond:
            try:
                m.queue.remove(req)
            except ValueError:
                return False        # already dispatched (or drained)
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.queue")
                _tsan.note_write("serving.ModelServer.stats")
            m.pending -= req.n
            self._stats["cancelled"] += 1
            self._stats["failed"] += 1
            self._cond.notify_all()
        req.future._set_exception(ServeCancelled(
            "request %d cancelled while queued" % req.rid))
        return True

    def predict(self, inputs: Optional[Dict] = None,
                model: Optional[str] = None, **kw) -> List[torch.Tensor]:
        """submit + block: the synchronous convenience surface."""
        return self.submit(inputs, model=model, **kw).result()

    def _resolve(self, model: Optional[str]) -> _Model:
        if model is None:
            if len(self._models) != 1:
                raise MXNetError("model= required on a multi-tenant "
                                 "server (have %s)" % sorted(self._models))
            return next(iter(self._models.values()))
        if model not in self._models:
            raise MXNetError("unknown model %r (have %s)"
                             % (model, sorted(self._models)))
        return self._models[model]

    # ------------------------------------------------------------------
    # scheduler
    def _loop(self):
        # supervision wrapper: an exception that escapes the cycle body
        # (a scheduler BUG, not a bad batch — those are handled below)
        # must fail every pending future and flip the server to
        # rejecting.  A crashed scheduler that silently strands futures
        # is the one failure mode this layer may never have.
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._loop_body()
        except Exception as e:                      # noqa: BLE001
            self._on_crash(e)

    def _loop_body(self):
        while True:
            with self._cond:
                if self._stop:
                    return
                wait = self._next_due_s()
                if wait is None or wait > 0:
                    self._cond.wait(timeout=wait)
                if self._stop:
                    return
                # round-robin: rotate which model is served FIRST each
                # cycle, so one hot tenant's batch time cannot
                # systematically age (and deadline-shed) the others
                models = list(self._models.values())
                if len(models) > 1:
                    k = self._rr % len(models)
                    models = models[k:] + models[:k]
                    self._rr += 1
            if _faults.hit("batch_error", site="sched"):
                raise ServeError("injected scheduler crash "
                                 "(batch_error@sched)")
            for m in models:
                batch = self._take_batch(m)
                if not batch:
                    continue
                t_pace = time.perf_counter()
                try:
                    self._run_batch(m, batch)
                except Exception as e:              # noqa: BLE001
                    # the scheduler thread must OUTLIVE any one bad
                    # batch: fail these futures, keep serving the rest
                    with self._cond:
                        self._stats["failed"] += sum(
                            1 for r in batch if not r.future.done())
                    for r in batch:
                        if not r.future.done():
                            r.future._set_exception(ServeError(
                                "serve cycle failed: %s" % e))
                if self.pace_rps > 0:
                    # per-replica capacity emulation: the batch "costs"
                    # rows/pace_rps seconds of device time, whatever the
                    # host CPU actually took — no lock held, so submits,
                    # cancels, and the drain all proceed under the sleep
                    left = sum(r.n for r in batch) / self.pace_rps \
                        - (time.perf_counter() - t_pace)
                    if left > 0:
                        time.sleep(left)

    def _on_crash(self, exc) -> None:
        """Scheduler supervision: fail EVERY pending future, then flip
        the server to rejecting (submit raises ServeUnavailable).  A
        late submit that raced the crash is failed by the sweep or
        refused by the flag — nothing hangs."""
        leftovers = []
        with self._cond:
            self._crashed = exc
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.queue")
                _tsan.note_write("serving.ModelServer.stats")
            for m in self._models.values():
                while m.queue:
                    leftovers.append(m.queue.popleft())
                m.pending = 0
            self._stats["failed"] += len(leftovers)
            self._cond.notify_all()
        for r in leftovers:
            r.future._set_exception(ServeUnavailable(
                "scheduler crashed before serving this request: %s"
                % exc))

    def _next_due_s(self) -> Optional[float]:
        """Seconds until the earliest queue needs attention (None =
        nothing pending, sleep until notified)."""
        now = time.perf_counter()
        due = None
        for m in self._models.values():
            if not m.queue:
                continue
            head = m.queue[0]
            t = head.t_in + self.max_wait_s
            if head.deadline is not None:
                t = min(t, head.deadline)
            if m.pending >= self.cap or self._draining:
                t = now
            due = t if due is None else min(due, t)
        if due is None:
            return None
        return max(0.0, due - now)

    def _take_batch(self, m: _Model) -> List[_Request]:
        """Pop the next admissible batch (largest prefix of the queue
        within ``cap`` rows) — or nothing if the coalescing window is
        still open.  Expired requests fail here, before ever entering a
        batch — and so do requests whose REMAINING deadline cannot
        cover the model's EWMA batch latency: dispatching them would
        burn a compute slot on a result that arrives dead on delivery
        (``shed_deadline``).  Every ``_SHED_PROBE_EVERY`` consecutive
        sheds, one request is let through as a latency PROBE — an
        anomalous slow batch that inflated the EWMA past every deadline
        must not latch the model into shedding forever (the probe's
        real latency re-feeds the EWMA and decays it)."""
        # read the latency estimate before taking _cond (the estimate
        # lives under the CompiledForward lock; never nest the two)
        ewma = m.cf.expected_latency_s()
        now = time.perf_counter()
        expired, shed = [], []
        with self._cond:
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.queue")
            while m.queue and m.queue[0].deadline is not None:
                r = m.queue[0]
                if r.deadline <= now:
                    expired.append(m.queue.popleft())
                    m.pending -= r.n
                elif ewma is not None and r.deadline - now < ewma:
                    if m.sheds_since_batch >= self._SHED_PROBE_EVERY:
                        break          # dispatch it as the probe
                    shed.append(m.queue.popleft())
                    m.pending -= r.n
                    m.sheds_since_batch += 1
                else:
                    break
            if expired:
                self._stats["timeouts"] += len(expired)
                self._stats["failed"] += len(expired)
            if shed:
                self._stats["shed_deadline"] += len(shed)
                self._stats["failed"] += len(shed)
            if not m.queue:
                batch = []
            else:
                waited = now - m.queue[0].t_in
                if m.pending < self.cap and waited < self.max_wait_s \
                        and not self._draining:
                    batch = []
                else:
                    batch, total = [], 0
                    while m.queue:
                        r = m.queue[0]
                        if total and total + r.n > self.cap:
                            break
                        batch.append(m.queue.popleft())
                        m.pending -= r.n
                        total += r.n
                        if total >= self.cap:
                            break
            if expired or shed or batch:
                # freed rows: wake block-policy submitters and the
                # stop(drain_s) wait
                self._cond.notify_all()
        for r in expired:
            r.future._set_exception(ServeTimeout(
                "request %d expired after %.0f ms in queue"
                % (r.rid, (now - r.t_in) * 1e3)))
        for r in shed:
            r.future._set_exception(ServeTimeout(
                "request %d shed: remaining deadline %.0f ms < EWMA "
                "batch latency %.0f ms — it would expire in flight"
                % (r.rid, (r.deadline - now) * 1e3, ewma * 1e3)))
        return batch

    def _bucket_for(self, total: int) -> Optional[int]:
        for b in self.buckets:
            if b >= total:
                return b
        return None

    def _run_batch(self, m: _Model, batch: List[_Request]) -> None:
        total = sum(r.n for r in batch)
        bucket = self._bucket_for(total)
        # oversized fallback: the exact shape (a retrace)
        padded = total if bucket is None else bucket
        broot = None
        if _obs.OBS:
            # one span tree per dispatched batch, recorded on the
            # scheduler thread; member requests are linked BOTH ways
            # (the batch lists their correlation IDs, each request
            # notes the batch's) so obs_report can bill the shared
            # pad/dispatch/execute/slice segments to every member
            t_take = time.perf_counter()
            broot = _obs.span(
                "serve.batch", corr="b%d" % batch[0].rid, parent=None,
                attrs={"model": m.name, "rows": total, "padded": padded,
                       "requests": ["r%d" % r.rid for r in batch]})
            for r in batch:
                if r.queue_span is not None:
                    r.queue_span.finish(t=t_take)
                if r.span is not None:
                    r.span.attrs["batch"] = broot.corr
        try:
            self._assemble_and_run(m, batch, total, padded, broot)
        finally:
            if broot is not None:
                broot.finish()

    def _assemble_and_run(self, m: _Model, batch: List[_Request],
                          total: int, padded: int, broot) -> None:
        # assemble the padded batch on the host (pinned on the card, so
        # the forward's copy-in is asynchronous); a slow request stalls
        # only its own cycle (the fault models a slow payload deserialize)
        with _obs.span("serve.pad", parent=broot):
            for r in batch:
                if r.slow:
                    time.sleep(float(os.environ.get("MXTPU_SERVE_SLOW_S",
                                                    "0.05")))
            feed = {}
            for iname, trailing in m.example_shapes.items():
                dt = m.input_dtypes[iname]
                parts = []
                for r in batch:
                    a = r.inputs[iname]
                    if r.poisoned and dt.is_floating_point:
                        a = torch.full(a.shape, float("nan"), dtype=dt)
                    parts.append(a)
                if padded > total:
                    parts.append(torch.zeros((padded - total,) + trailing,
                                             dtype=dt))
                feed[iname] = self._stage(parts, (padded,) + trailing, dt)
            feed.update(self._labels(m, padded))
        t_run = time.perf_counter()
        try:
            # batch_error: the injectable whole-batch failure (a wedged
            # graph, a poisoned weight buffer) that drives the circuit
            # breaker in tests — MXTPU_FAULTS
            # "batch_error@model=NAME:count=K"
            if _faults.hit("batch_error", model=m.name):
                raise ServeError("injected batch_error (model %r)"
                                 % m.name)
            with _obs.span("serve.dispatch", parent=broot):
                outs, flags, done = m.cf.run(
                    m.params, m.aux, feed, device=self.device,
                    graphs=m.graphs,
                    take=lambda o: self._copy_out(o, [r.n for r in batch]))
            with _obs.span("serve.execute", parent=broot):
                # the device wait: the copy-out of the real rows (and
                # their finiteness flags) has landed in host memory
                if done is not None:
                    done.synchronize()
        except Exception as e:                        # noqa: BLE001
            self._batch_failed(m, batch, e)
            return
        self._complete_batch(m, batch, total, padded, (outs, flags), t_run,
                             broot)

    def _stage(self, parts, shape, dtype) -> torch.Tensor:
        """The batch of one input on the host: pinned on the card."""
        if self.device.type != "cuda":
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.cat(parts, out=buf)

    def _labels(self, m: _Model, padded: int) -> Dict[str, torch.Tensor]:
        """Zero-filled label inputs at ``padded`` rows, made once on the
        device (the scheduler thread alone reads and fills the cache)."""
        lab = m.labels.get(padded)
        if lab is None:
            lab = m.labels[padded] = {
                n: torch.zeros((padded,) + t, dtype=m.input_dtypes[n],
                               device=self.device)
                for n, t in m.label_trailing.items()}
        return lab

    def _copy_out(self, outs, counts: List[int]):
        """Each request's rows of each output on the host (``counts``:
        the requests' row counts, in batch order), with one flag per real
        row (every floating output finite) when ``validate`` is on, both
        computed from the device's values; on the card the copies are
        enqueued into pinned memory and the returned event marks their
        end.  Returns ``(per-request outputs, flags or None, event or
        None)``.

        Each request's rows land in a host block of their own, so a
        result its caller keeps holds those rows and nothing of its
        batch-mates'.  On the card the caching host allocator hands a
        pinned block that no result holds any more to the next request of
        its size, and ``start()`` allocates one per bucket size: a fresh
        block of a size new to the process costs about 0.25 s a GB to
        pin, more than its copy."""
        total = sum(counts)
        flags = None
        if self.validate:
            fin = [torch.isfinite(o[:total].reshape(total, -1)).all(1)
                   for o in outs if o.is_floating_point()]
            if fin:
                flags = torch.stack(fin).all(0)
        starts = [0]
        for n in counts[:-1]:
            starts.append(starts[-1] + n)
        if self.device.type != "cuda":
            return ([[o[s:s + n].clone() for o in outs]
                     for s, n in zip(starts, counts)], flags, None)
        host = [[torch.empty((n,) + tuple(o.shape[1:]), dtype=o.dtype,
                             pin_memory=True)
                 .copy_(o[s:s + n], non_blocking=True) for o in outs]
                for s, n in zip(starts, counts)]
        if flags is not None:
            flags = torch.empty(flags.shape, dtype=flags.dtype,
                                pin_memory=True).copy_(flags,
                                                       non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, flags, done

    def _complete_batch(self, m: _Model, batch: List[_Request],
                        total: int, padded: int, result, t_run,
                        broot) -> None:
        """Post-compute completion: batch bookkeeping, then slice the
        outputs back per request and settle every future.  One span
        (``serve.slice``) covers the whole phase, so the per-request
        segments tile the measured end-to-end latency."""
        with _obs.span("serve.slice", parent=broot):
            self._settle_batch(m, batch, total, padded, result, t_run)

    def _settle_batch(self, m: _Model, batch: List[_Request],
                      total: int, padded: int, result, t_run) -> None:
        # t_run to here spans the replay and the copy-out: the device's
        # time, not the host's enqueue
        m.cf.record_latency(padded, time.perf_counter() - t_run)
        outs, flags = result
        with self._cond:
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.stats")
            self._stats["batches"] += 1
            self._stats["rows_real"] += total
            self._stats["rows_padded"] += padded
            if m.pad_ctrs is not None:
                m.pad_ctrs["rows_real"] += total
                m.pad_ctrs["rows_padded"] += padded
            occ = self._occupancy.setdefault(padded, [0, 0])
            occ[0] += 1
            occ[1] += total
            m.batches += 1
            m.sheds_since_batch = 0    # a batch ran: fresh EWMA evidence
            # breaker success: a served batch closes a half-open
            # breaker and resets the consecutive-failure count
            m.consec_failures = 0
            if m.breaker == "half_open":
                m.breaker = "closed"
                m.opened_at = None
        now = time.perf_counter()
        off = 0
        for r, rows in zip(batch, outs):
            bad = flags is not None and not bool(flags[off:off + r.n].all())
            off += r.n
            if r.deadline is not None and r.deadline < now:
                # expiry re-checked AFTER compute: a late result fails
                # its future honestly instead of pretending the
                # deadline held (the client has already moved on)
                with self._cond:
                    self._stats["expired_after_dispatch"] += 1
                    self._stats["failed"] += 1
                r.future._set_exception(ServeTimeout(
                    "request %d expired in flight: result ready %.0f ms "
                    "past its deadline" % (r.rid,
                                           (now - r.deadline) * 1e3)))
                continue
            with self._cond:
                self._stats["failed" if bad else "completed"] += 1
            if bad:
                r.future._set_exception(ServeError(
                    "request %d produced non-finite outputs (poisoned "
                    "or invalid payload); the rest of the batch was "
                    "unaffected" % r.rid))
            else:
                r.future._set_result(rows)
                # completed-request latency into the per-model
                # fixed-bucket histogram (stats() p50/p95/p99)
                m.lat_hist.observe(
                    (r.future.t_done - r.future.t_submit) * 1e3)

    def _batch_failed(self, m: _Model, batch: List[_Request], exc) -> None:
        """Whole-batch failure: fail the batch's futures, feed the
        circuit breaker.  ``breaker_k`` consecutive failures (or ONE
        failed half-open probe) open it — the model's queue is flushed
        and new submits fail fast with ServeUnavailable until the
        cool-down admits a probe.  Other tenants are untouched."""
        flushed = []
        with self._cond:
            if _tsan.TSAN:
                _tsan.note_write("serving.ModelServer.queue")
                _tsan.note_write("serving.ModelServer.stats")
            self._stats["failed"] += len(batch)
            self._stats["batch_failures"] += 1
            m.consec_failures += 1
            if self.breaker_k and (
                    m.breaker == "half_open"
                    or (m.breaker == "closed"
                        and m.consec_failures >= self.breaker_k)):
                m.breaker = "open"
                m.opened_at = time.perf_counter()
                while m.queue:
                    flushed.append(m.queue.popleft())
                m.pending = 0
                self._stats["failed"] += len(flushed)
            self._cond.notify_all()
        for r in batch:
            r.future._set_exception(ServeError(
                "batched forward failed: %s" % exc))
        for r in flushed:
            r.future._set_exception(ServeUnavailable(
                "model %r circuit breaker opened while this request "
                "was queued (%d consecutive batch failures)"
                % (m.name, m.consec_failures)))

    # ------------------------------------------------------------------
    # observability
    def stats(self) -> Dict:
        """Counters + batch-occupancy histogram + retrace accounting —
        one atomic snapshot per lock: the server counters under
        ``_cond`` (the scheduler mutates them mid-cycle), each compiled
        forward's trace counters under ITS lock (``cf.counts()``; a
        concurrent lazy trace bumps them from another thread)."""
        now = time.perf_counter()
        with self._cond:
            if _tsan.TSAN:
                _tsan.note_read("serving.ModelServer.stats")
                _tsan.note_read("serving.ModelServer.queue")
            s = dict(self._stats)
            occ = {str(b): {"batches": v[0],
                            "mean_fill": round(v[1] / (v[0] * b), 3)}
                   for b, v in sorted(self._occupancy.items())}
            depth = sum(len(m.queue) for m in self._models.values())
            crashed = self._crashed
            per_model = {}
            for name in sorted(self._models):
                m = self._models[name]
                per_model[name] = {
                    "queue_depth_rows": m.pending,
                    "queue_depth": len(m.queue),
                    "oldest_wait_ms": round(
                        (now - m.queue[0].t_in) * 1e3, 3)
                    if m.queue else 0.0,
                    "breaker_state": m.breaker,
                    "consec_failures": m.consec_failures,
                    "batches": m.batches,
                    "weight_bytes_on_device": m.weight_bytes_on_device,
                    "quant": m.quant,
                    "predicted_peak_bytes": m.predicted_peak_bytes,
                    # why the tenant's forward runs uncaptured, or None
                    "uncaptured": m.cf.uncaptured,
                }
        # the latency EWMA lives under each CompiledForward's own lock;
        # read it AFTER releasing _cond (never nest the two) — same for
        # the registry-backed latency histogram (its own mutex)
        for name, pm in per_model.items():
            mm = self._models[name]
            ewma = mm.cf.expected_latency_s()
            pm["ewma_batch_ms"] = None if ewma is None \
                else round(ewma * 1e3, 3)
            pm["latency_ms_by_bucket"] = mm.cf.latency_ms_by_bucket()
            # fixed-bucket percentiles over COMPLETED requests: the
            # EWMA answers "what will the next batch cost", the
            # histogram answers "what did clients actually see"
            pm["latency_ms"] = mm.lat_hist.percentiles((50, 95, 99))
            # per-model pad fit (registry-backed counters, own mutex):
            # how many dispatched rows were bucket padding for THIS
            # tenant
            pr = mm.pad_ctrs["rows_padded"] if mm.pad_ctrs else 0
            rr = mm.pad_ctrs["rows_real"] if mm.pad_ctrs else 0
            pm["pad_rows"] = pr - rr
            pm["pad_frac"] = round(1.0 - rr / pr, 4) if pr else 0.0
        s["occupancy"] = occ
        s["padding_frac"] = round(
            1.0 - s["rows_real"] / s["rows_padded"], 4) \
            if s["rows_padded"] else 0.0
        s["queue_depth"] = depth
        s["per_model"] = per_model
        s["scheduler_crashed"] = bool(crashed)
        s["policy"] = {"queue_cap": self.queue_cap,
                       "shed_policy": self.shed_policy,
                       "breaker_k": self.breaker_k,
                       "breaker_cooldown_ms": round(
                           self.breaker_cooldown_s * 1e3, 1),
                       "precision": self.precision,
                       "mem_budget_bytes": self.mem_budget}
        s["buckets"] = list(self.buckets)
        # this server's namespace in the process-wide metrics registry
        # (obs.snapshot() — the surface a fleet router scrapes)
        s["obs_scope"] = self._obs_scope
        counts = [cf.counts() for cf, _ in self._cf_groups()]
        s["aot_compiles"] = sum(c["aot"] for c in counts)
        s["retraces"] = sum(c["retraces"] for c in counts)
        # the CUDA graphs of the tenants' compiled forwards (0 on the
        # CPU), those a Predictor over the same model captured included
        s["graph_captures"] = sum(c["graph_captures"] for c in counts)
        s["graph_replays"] = sum(c["graph_replays"] for c in counts)
        s["models"] = sorted(self._models)
        return s

    def load_report(self) -> Dict:
        """The router's polling surface: per-model queue depth (rows),
        breaker state and batch-latency EWMA, plus this server's
        availability flags — WITHOUT taking ``_cond``.

        A fleet router calls this once or twice per submit
        (power-of-two-choices), so it must never contend with the
        scheduler: the ints and strings read here are single mutations
        under the GIL (their writers hold ``_cond``; a reader sees the
        previous or the next value, never a torn one), and the EWMA
        lives under each CompiledForward's own lock.  Staleness by one
        scheduler cycle is inherent to load-balancing on polled load —
        the score only has to be right on average.  Measured on the CPU
        tier: ~3-4 µs/call single-tenant vs ~80-120 µs for the full
        ``stats()`` snapshot (which takes ``_cond`` and walks every
        histogram) — cheap enough to poll per submit.
        """
        if _tsan.TSAN:
            _tsan.note_read(
                "serving.ModelServer.load_report", lockfree=True,
                reason="router polling path: GIL-atomic reads of ints/"
                       "strs whose writers hold _cond; one-cycle "
                       "staleness is part of the load-score contract")
        per_model = {}
        for name, m in list(self._models.items()):
            ewma = m.cf.expected_latency_s()
            per_model[name] = {
                "queue_depth_rows": m.pending,
                "breaker_state": m.breaker,
                "ewma_batch_ms": None if ewma is None
                else ewma * 1e3,
                "weight_bytes_on_device": m.weight_bytes_on_device,
                "quant": m.quant,
            }
        return {
            "available": bool(self._started) and not self._stop
            and not self._draining and self._crashed is None,
            "draining": bool(self._draining),
            "crashed": self._crashed is not None,
            "per_model": per_model,
        }

    def _cf_groups(self):
        """``(cf, [model names])`` with shared compiled forwards
        deduplicated — two tenants over the same symbol (an A/B of two
        checkpoints of one architecture) share ONE CompiledForward, and
        summing it per model would double-count its traces."""
        groups = {}
        for name in sorted(self._models):
            cf = self._models[name].cf
            groups.setdefault(id(cf), (cf, []))[1].append(name)
        return list(groups.values())

    def assert_no_retrace(self) -> None:
        """Raise unless every compilation so far was an AOT bucket —
        the zero-steady-state-retrace acceptance gate."""
        bad, total = {}, 0
        for cf, names in self._cf_groups():
            if cf.retraces:
                bad["+".join(names)] = cf.offbucket_batch_sizes(
                    self.buckets)
                total += cf.retraces
        if bad:
            raise MXNetError(
                "serve path retraced: %d compilation(s) beyond the AOT "
                "bucket set %s — off-bucket batch sizes per model: %s"
                % (total, self.buckets, bad))

    def lint(self):
        """The JAX package's ``serve-shape-bucket`` lint pass; it waits
        for the port's static analyses."""
        raise MXNetError("ModelServer.lint() waits for the port's static "
                         "analyses (ROADMAP queue A item 10); "
                         "assert_no_retrace() checks the same retraces")
