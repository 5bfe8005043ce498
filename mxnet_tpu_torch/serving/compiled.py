"""Keyed compiled-forward cache (``mxnet_tpu/serving/compiled.py``): one
eval forward per (symbol, inputs, platform, policy), shared by every
consumer, with the weights as arguments.

A :class:`CompiledForward` is a symbol's eval forward with the **weights
as arguments**: the caller keeps the weights on the device once and
passes them with each batch.  Two Predictors or server tenants over the
same (symbol, input names, platform, policy) resolve to ONE entry of the
process-wide cache (:func:`compiled_forward`), and so to one signature
registry and one latency record.

The JAX package lowers and compiles a signature ahead of time; the torch
analog here is the **CUDA graph**.  :meth:`CompiledForward.aot_compile`
registers a batch signature; on a CUDA device, given the caller's graph
holder (a dict), it also runs the forward once eagerly off the caller's
stream (lazy library set-up, allocator warm-up) and captures it into a
``torch.cuda.CUDAGraph`` over static input buffers, kept in that holder.
A symbol with a node whose body runs Python (a ``Custom`` op) is never
captured: its forward runs eagerly on the card, and ``uncaptured`` names
those nodes.
:meth:`CompiledForward.run` at a registered signature on the card, with
a holder, copies the batch into the graph's inputs and replays; anywhere
else it runs the forward eagerly, and a signature that was never
registered counts as a lazy trace, a **retrace** (once per signature, as
a jit cache would trace it once).  On the CPU a registered signature
runs eagerly and counts nothing.

The graphs live with their owner (a Predictor, a server tenant), not in
the process-wide cache: an owner that goes away takes its graphs, their
static buffers and their share of the memory pool with it, while the
signature registry and the latency record stay shared.

Every bucket graph of a device is captured into one memory pool, so the
graphs share their intermediate buffers.  Their static inputs live
outside the pool and their static outputs stay allocated, but a replay
of one graph may overwrite another graph's outputs.  So every replay of
a device runs on one stream of this module's, under one lock, from the
copy-in through ``run(..., take=...)``, where the caller takes what it
needs from the outputs (a copy-out) on its own stream, which waits for
the replay; the next replay waits for that copy.  A caller on any stream
of its own thus never runs beside another replay.

Eval-mode randomness: each CompiledForward owns a private generator per
device, seeded 0 again before every forward (before every replay on the
card, where a graph that draws registers it), so every call draws the
same stream, as the JAX package's constant key ``jax.random.key(0)``
does.  A request's result then never depends on the requests that share
its batch or on how often a graph was replayed.  The streams differ from
the JAX package's (philox against threefry).

The JAX package's persisted program cache (``MXTPU_PROGRAM_CACHE``) has
no counterpart yet: :meth:`~CompiledForward.aot_compile` never returns
``"loaded"``.
"""
from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import _tsan
from ..base import MXNetError, _dtype
from ..executor import _GraphProgram

__all__ = ["CompiledForward", "compiled_forward", "cache_stats",
           "clear_cache", "infer_input_dtypes", "symbol_digest"]


class _Device:
    """What the bucket graphs of one CUDA device share: the memory pool
    they are captured into and how many captured graphs live in it, the
    lock that serialises their captures and replays, and the stream they
    replay on."""

    __slots__ = ("pool", "graphs", "lock", "stream")

    def __init__(self, device: torch.device):
        self.pool = None
        self.graphs = 0
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device)

    def take_pool(self):
        """The pool a new capture goes into.  A pool whose graphs were
        all released is not handed out again (the allocator keeps its
        entry until its blocks are freed, and refuses a new capture into
        it): a fresh one takes its place."""
        with _DEVICE_LOCK:
            if self.pool is None or self.graphs == 0:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs += 1
            return self.pool

    def release(self, pool) -> None:
        """A graph captured into ``pool`` was freed."""
        with _DEVICE_LOCK:
            if pool == self.pool:
                self.graphs -= 1


_DEVICES: Dict[torch.device, _Device] = {}
_DEVICE_LOCK = threading.Lock()


def _device_state(device: torch.device) -> _Device:
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _DEVICE_LOCK:
        state = _DEVICES.get(device)
        if state is None:
            state = _DEVICES[device] = _Device(device)
        return state


def symbol_digest(symbol) -> str:
    """The cache-identity digest of a Symbol: sha1 of its JSON, as the
    JAX package's ``program.symbol_digest``."""
    return hashlib.sha1(symbol.tojson().encode()).hexdigest()


def infer_input_dtypes(symbol, params, input_names: Sequence[str],
                       declared: Optional[Dict] = None) -> Dict:
    """The staging dtype per input: declared by the caller > what
    ``infer_type`` back-derives from the LOADED param dtypes (a bf16
    checkpoint binds bf16 inputs) > float32.  One rule shared by the
    Predictor and the serving buckets."""
    inferred = {}
    try:
        types, _, _ = symbol.infer_type(
            **{n: v.dtype for n, v in params.items()})
        inferred = {n: t for n, t in zip(symbol.list_arguments(), types)
                    if t is not None}
    except MXNetError:
        pass
    out = {}
    for n in input_names:
        if declared and n in declared:
            out[n] = _dtype(declared[n])
        else:
            out[n] = inferred.get(n, torch.float32)
    return out


def _signature(batch_shapes: Dict[str, tuple], dtypes: Dict,
               device: torch.device) -> Tuple:
    return (str(device),) + tuple(sorted(
        (n, tuple(int(d) for d in s), dtypes[n])
        for n, s in batch_shapes.items()))


class _BucketGraph:
    """One captured forward: the graph, its static inputs and outputs,
    and the weights whose addresses it reads (held, so they stay).  Its
    owner's graph holder keeps it; when the last reference goes, the
    graph, its buffers and its share of the pool go too."""

    __slots__ = ("graph", "inputs", "outputs", "weights", "__weakref__")

    def __init__(self, graph, inputs, outputs, weights):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.weights = weights


class CompiledForward:
    """A symbol's inference forward, weights as arguments, with a
    signature registry, trace counters and a latency record; on the card
    a CUDA graph per registered signature and weight set, kept in the
    graph holder of the caller that registered it."""

    def __init__(self, symbol, input_names: Sequence[str],
                 platform: Optional[str] = None,
                 dtype_policy: Optional[str] = None):
        self.symbol = symbol
        self.prog = _GraphProgram(symbol)
        self.prog.dtype_policy = dtype_policy
        self.platform = platform
        self.input_names = tuple(input_names)
        missing = [n for n in self.input_names
                   if n not in self.prog.arg_names]
        if missing:
            raise MXNetError("inputs %s are not arguments of this symbol "
                             "(have %s)" % (missing, self.prog.arg_names))
        inputs = set(self.input_names)
        self.param_names = [n for n in self.prog.arg_names if n not in inputs]
        self.aux_names = list(self.prog.aux_names)
        # a graph of a forward that draws registers the generator
        self.draws = any(n.op.uses_rng and n.op.rng_in_eval
                         for n in self.prog.nodes if not n.is_variable)
        # why this forward is never captured (a node whose body runs
        # Python on the host), None where it is; decided here, before
        # any request
        from ..operator import uncapturable
        self.uncaptured = uncapturable(self.prog.nodes)
        self._lock = _tsan.lock("serving.CompiledForward._lock")
        self._capture_lock = threading.Lock()
        self.trace_count = 0
        self._aot_sigs: set = set()
        self._lazy_sigs: List[Tuple] = []
        self.traced_batch_sizes: List[int] = []   # one entry per trace
        # traces outside aot_compile: each one a signature no bucket or
        # Predictor registered (the retraces)
        self.lazy_batch_sizes: List[int] = []
        self.graph_captures = 0
        self.graph_replays = 0
        self._generators: Dict[torch.device, torch.Generator] = {}
        # execute-latency EWMA (overall + per padded batch size), fed by
        # the server after each batch and read by its deadline shedding
        self._ewma_run_s: Optional[float] = None
        self._bucket_run_s: Dict[int, float] = {}

    # ------------------------------------------------------------------
    def _generator(self, device: torch.device) -> torch.Generator:
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
        return gen

    def _forward(self, params, aux, batch, device, reseed=True):
        """The eval forward, eagerly; ``reseed`` restarts the private
        stream first (not allowed inside a capture: the caller seeds
        before it)."""
        gen = self._generator(device)
        if reseed and self.draws:
            gen.manual_seed(0)
        vals = [batch[n] if n in self.input_names else params[n]
                for n in self.prog.arg_names]
        with torch.no_grad():
            return self.prog._eval(vals, [aux[n] for n in self.aux_names],
                                   device, rng=gen)[0]

    def _batch_dim(self, batch_shapes) -> int:
        for n in self.input_names:
            s = batch_shapes.get(n)
            if s:
                return int(s[0])
        return 0

    def _weights_key(self, params, aux) -> Tuple:
        return tuple(params[n].data_ptr() for n in self.param_names) \
            + tuple(aux[n].data_ptr() for n in self.aux_names)

    @staticmethod
    def _device(params, aux, batch) -> torch.device:
        for group in (params, aux, batch):
            for v in group.values():
                return v.device
        return torch.device("cpu")

    # ------------------------------------------------------------------
    def aot_compile(self, params, aux, batch_shapes: Dict[str, tuple],
                    batch_dtypes: Optional[Dict] = None,
                    device: Optional[torch.device] = None,
                    graphs: Optional[Dict] = None) -> str:
        """Register one input signature ahead of time (server start /
        Predictor construction).  On a CUDA device (the weights', or
        ``device`` for a forward without weights), given ``graphs`` (the
        caller's graph holder, a dict it keeps for as long as it serves),
        this runs the forward once eagerly off the caller's stream and
        captures it in a CUDA graph for these weights, kept in
        ``graphs``.  Returns ``"cached"`` (signature already registered)
        or ``"compiled"``."""
        dtypes = {n: (batch_dtypes or {}).get(n, torch.float32)
                  for n in batch_shapes}
        if device is None:
            device = self._device(params, aux, {})
        sig = _signature(batch_shapes, dtypes, device)
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_write("serving.CompiledForward.counters")
            verdict = "cached" if sig in self._aot_sigs else "compiled"
            if verdict == "compiled":
                self._aot_sigs.add(sig)
                self.trace_count += 1
                self.traced_batch_sizes.append(self._batch_dim(batch_shapes))
        if device.type == "cuda" and graphs is not None \
                and self.uncaptured is None:
            self._graph(graphs, sig, params, aux, batch_shapes, dtypes,
                        device)
        return verdict

    def _graph(self, graphs, sig, params, aux, batch_shapes, dtypes,
               device):
        key = (sig, self._weights_key(params, aux))
        with self._capture_lock:
            entry = graphs.get(key)
            if entry is None:
                entry = graphs[key] = self._capture(
                    params, aux, batch_shapes, dtypes, device)
        return entry

    def _capture(self, params, aux, batch_shapes, dtypes, device):
        inputs = {n: torch.zeros(s, dtype=dtypes[n], device=device)
                  for n, s in batch_shapes.items()}
        # the warm-up runs on the replay stream, off the caller's: a new
        # stream for each capture would leave a cuBLAS workspace behind
        # for each (34 MiB that nothing frees)
        state = _device_state(device)
        current = torch.cuda.current_stream(device)
        state.stream.wait_stream(current)
        with torch.cuda.stream(state.stream):
            self._forward(params, aux, inputs, device)
        current.wait_stream(state.stream)
        graph = torch.cuda.CUDAGraph()
        gen = self._generator(device)
        if self.draws:
            graph.register_generator_state(gen)
            gen.manual_seed(0)
        pool = state.take_pool()
        # counted from here, released when the graph goes (a failed
        # capture's graph included)
        entry = _BucketGraph(graph, inputs, None,
                             (list(params.values()), list(aux.values())))
        weakref.finalize(entry, state.release, pool)
        try:
            with state.lock, torch.cuda.device(device), \
                    torch.cuda.graph(graph, pool=pool,
                                     capture_error_mode="thread_local"):
                outputs = self._forward(params, aux, inputs, device,
                                        reseed=False)
        except Exception as err:       # noqa: BLE001 - re-raised, named
            raise MXNetError("capturing the eval forward at %s in a CUDA "
                             "graph failed: %s: %s"
                             % ({n: tuple(s) for n, s in
                                 batch_shapes.items()},
                                type(err).__name__, err)) from err
        entry.outputs = outputs
        with self._lock:
            self.graph_captures += 1
        return entry

    def run(self, params, aux, batch: Dict,
            take: Optional[Callable] = None,
            device: Optional[torch.device] = None,
            graphs: Optional[Dict] = None):
        """Execute the forward on ``device``, by default the weights'
        (the batch's, for a forward without weights); ``batch`` maps
        every input name to a tensor, on the host or that device.
        Returns the output tuple, or ``take(outputs)`` when ``take`` is
        given.

        At a registered signature on the card, with the caller's graph
        holder ``graphs``, this replays the holder's graph on the
        device's replay stream, and the outputs are the graph's own
        buffers, rewritten by the next replay of any graph of the
        device.  The caller's current stream waits for the replay, and
        ``take`` runs on it while no other replay can be enqueued; the
        next replay waits for what ``take`` enqueued, so a copy it
        enqueues reads this replay's values."""
        if device is None:
            device = self._device(params, aux, batch)
        shapes = {n: tuple(v.shape) for n, v in batch.items()}
        sig = _signature(shapes, {n: v.dtype for n, v in batch.items()},
                         device)
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_write("serving.CompiledForward.counters")
            known = sig in self._aot_sigs
            if not known and sig not in self._lazy_sigs:
                b = self._batch_dim(shapes)
                self._lazy_sigs.append(sig)
                self.trace_count += 1
                self.traced_batch_sizes.append(b)
                self.lazy_batch_sizes.append(b)
        if device.type != "cuda" or not known or graphs is None \
                or self.uncaptured is not None:
            feed = {n: v.to(device, non_blocking=True)
                    for n, v in batch.items()}
            outs = self._forward(params, aux, feed, device)
            return outs if take is None else take(outs)
        entry = self._graph(graphs, sig, params, aux, shapes,
                            {n: v.dtype for n, v in batch.items()}, device)
        state = _device_state(device)
        with state.lock:
            caller = torch.cuda.current_stream(device)
            state.stream.wait_stream(caller)
            with torch.cuda.stream(state.stream):
                for n, v in batch.items():
                    entry.inputs[n].copy_(v, non_blocking=True)
                if self.draws:
                    self._generator(device).manual_seed(0)
                entry.graph.replay()
            caller.wait_stream(state.stream)
            out = entry.outputs if take is None else take(entry.outputs)
            state.stream.wait_stream(caller)
            with self._lock:
                self.graph_replays += 1
            return out

    # ------------------------------------------------------------------
    # latency bookkeeping (the server's deadline-aware shed reads this)
    _EWMA_ALPHA = 0.3

    def record_latency(self, rows: int, dt_s: float) -> None:
        """Fold one observed batch latency (``rows`` = the padded batch
        size that ran; the time up to the end of the copy-out) into the
        EWMA."""
        a = self._EWMA_ALPHA
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_write("serving.CompiledForward.latency")
            self._ewma_run_s = dt_s if self._ewma_run_s is None \
                else (1.0 - a) * self._ewma_run_s + a * dt_s
            prev = self._bucket_run_s.get(rows)
            self._bucket_run_s[rows] = dt_s if prev is None \
                else (1.0 - a) * prev + a * dt_s

    def expected_latency_s(self) -> Optional[float]:
        """The overall batch-latency EWMA (None until a batch has run)
        — what a queued request should budget for the compute ahead of
        it."""
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_read("serving.CompiledForward.latency")
            return self._ewma_run_s

    def latency_ms_by_bucket(self) -> Dict[str, float]:
        """Per-padded-batch-size latency EWMA snapshot."""
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_read("serving.CompiledForward.latency")
            return {str(b): round(v * 1e3, 3)
                    for b, v in sorted(self._bucket_run_s.items())}

    # ------------------------------------------------------------------
    def counts(self) -> Dict:
        """One atomic snapshot of the trace and graph accounting."""
        with self._lock:
            if _tsan.TSAN:
                _tsan.note_read("serving.CompiledForward.counters")
            return {"traces": self.trace_count,
                    "aot": len(self._aot_sigs),
                    "retraces": len(self._lazy_sigs),
                    "lazy_batch_sizes": list(self.lazy_batch_sizes),
                    "graph_captures": self.graph_captures,
                    "graph_replays": self.graph_replays}

    @property
    def aot_count(self) -> int:
        return self.counts()["aot"]

    @property
    def retraces(self) -> int:
        """Signatures run without registration — each one a shape the
        bucket padding (or a Predictor's registration) should have
        absorbed."""
        return self.counts()["retraces"]

    def offbucket_batch_sizes(self, buckets: Sequence[int]) -> List[int]:
        """Lazily-run batch sizes not in ``buckets``."""
        bset = set(int(b) for b in buckets)
        return sorted({b for b in self.counts()["lazy_batch_sizes"]
                       if b not in bset})


# ----------------------------------------------------------------------
_CACHE: Dict[Tuple, CompiledForward] = {}
_CACHE_LOCK = _tsan.lock("serving.compiled._CACHE_LOCK")
_HITS = 0
_MISSES = 0


def compiled_forward(symbol, input_names: Sequence[str],
                     platform: Optional[str] = None,
                     dtype_policy: Optional[str] = None) -> CompiledForward:
    """The process-wide keyed cache.  Key = (symbol JSON digest, sorted
    inputs, platform ``"cuda"``/``"cpu"``, dtype policy): two Predictors
    (or server tenants) over the same saved model resolve to the SAME
    CompiledForward."""
    global _HITS, _MISSES
    key = (symbol_digest(symbol), tuple(sorted(input_names)),
           platform, dtype_policy)
    with _CACHE_LOCK:
        cf = _CACHE.get(key)
        if cf is not None:
            _HITS += 1
            return cf
        _MISSES += 1
    # build outside the lock (graph walk), publish under it; a racing
    # duplicate build is harmless — first writer wins
    cf = CompiledForward(symbol, input_names, platform, dtype_policy)
    with _CACHE_LOCK:
        return _CACHE.setdefault(key, cf)


def cache_stats() -> Dict[str, int]:
    with _CACHE_LOCK:
        cfs = list(_CACHE.values())
        stats = {"entries": len(cfs), "hits": _HITS, "misses": _MISSES}
    stats["traces"] = sum(cf.counts()["traces"] for cf in cfs)
    return stats


def clear_cache() -> None:
    global _HITS, _MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0
