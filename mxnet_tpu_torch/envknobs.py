"""One registry for every ``MXTPU_*`` environment knob the port reads,
the port of ``mxnet_tpu/envknobs.py``.

A typo'd knob (``MXTPU_SERVE_QEUE_CAP=64``) configures NOTHING and says
nothing unless something checks the names; this module is that check:

* :data:`KNOBS` declares every knob the port reads — name, type,
  default, and the subsystem that owns it — with the JAX registry's
  names, kinds, defaults and docs (a knob means the same in both
  packages).  The JAX package's knobs for features the port has not
  taken on yet are not declared here.
* :func:`validate_environ` scans the process environment for
  ``MXTPU_*`` names that no code reads and warns loudly with a
  did-you-mean (``import mxnet_tpu_torch`` runs it once;
  ``MXTPU_STRICT_KNOBS=1`` escalates the warning to
  :class:`~mxnet_tpu_torch.base.MXNetError`).  Set knobs whose values
  don't parse as their declared type are flagged the same way.
* typed accessors (:func:`get_int` / :func:`get_float` /
  :func:`get_bool` / :func:`get_str`) give consuming sites one
  error-message shape (``NAME=value is not an integer``).

Knob RESOLUTION order at a consuming site is constructor argument, then
env, then default; this module only owns the env layer of that chain.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

from .base import MXNetError

__all__ = ["KNOBS", "declared", "is_set", "raw", "get_int", "get_float",
           "get_bool", "get_str", "validate_environ", "KnobWarning"]


class KnobWarning(UserWarning):
    """An ``MXTPU_*`` env var that no code reads (probable typo), or a
    set knob whose value cannot parse as its declared type."""


class _Knob:
    __slots__ = ("name", "kind", "default", "owner", "doc")

    def __init__(self, name, kind, default, owner, doc):
        self.name = name
        self.kind = kind          # int | float | bool | str | list
        self.default = default
        self.owner = owner
        self.doc = doc


def _k(name, kind, default, owner, doc):
    return name, _Knob(name, kind, default, owner, doc)


# every knob some site of the port reads.  "bool" knobs accept
# 0/1/true/false/yes/no; "list" is comma-separated ints; "str" values
# are validated by the consuming site (mode words, paths, fault specs).
KNOBS: Dict[str, _Knob] = dict((
    # --- execution / trainer (raised for, where a later slice has them) ----
    _k("MXTPU_MODULE_FUSED", "str", "auto", "module",
       "auto|always|never: route Module onto the fused Trainer"),
    _k("MXTPU_COMPUTE_DTYPE", "str", None, "module",
       "default compute dtype for modules (e.g. bfloat16)"),
    _k("MXTPU_DTYPE_POLICY", "str", None, "trainer",
       "bytediet|legacy residual-dtype policy of the fused step"),
    _k("MXTPU_REMAT", "str", "none", "trainer",
       "rematerialization policy: none|convs_dots|dots|nothing"),
    _k("MXTPU_ZERO", "int", 0, "trainer",
       "optimizer-state sharding stage (0|1)"),
    _k("MXTPU_GRAD_ACCUM", "int", 1, "trainer",
       "microbatch accumulation count"),
    _k("MXTPU_GRAD_DTYPE", "str", "f32", "trainer",
       "cross-chip gradient wire dtype: f32|bf16"),
    _k("MXTPU_DONATE_BATCH", "bool", False, "trainer",
       "donate the batch argument (frees staging buffers)"),
    _k("MXTPU_SENTINEL", "str", "off", "trainer",
       "step sentinel: off|skip|abort"),
    _k("MXTPU_SENTINEL_MAX_SKIPS", "int", 3, "trainer",
       "consecutive sentinel skips before abort raises"),
    _k("MXTPU_LOSS_SCALE", "str", None, "trainer",
       "off|dynamic|<float> cotangent loss scale"),
    _k("MXTPU_LS_GROWTH_INTERVAL", "int", 200, "trainer",
       "clean steps before the dynamic loss scale doubles"),
    _k("MXTPU_INTEGRITY_MODE", "str", "off", "trainer",
       "state-integrity mode: off|fp|vote|audit"),
    _k("MXTPU_INTEGRITY_PERIOD", "int", 100, "trainer",
       "updates between integrity checks"),
    _k("MXTPU_INTEGRITY_MAX_ROLLBACKS", "int", 3, "module",
       "consecutive integrity rollbacks before fit raises"),
    _k("MXTPU_TUNE_PLAN", "str", None, "tuneplan",
       "path to a persisted TUNE_PLAN.json applied at Trainer/"
       "ModelServer construction (env and ctor args override it)"),
    _k("MXTPU_STRICT_KNOBS", "bool", False, "envknobs",
       "escalate unknown-knob warnings to MXNetError"),
    # --- input pipeline ----------------------------------------------------
    _k("MXTPU_UPLOAD_OVERLAP", "bool", None, "io",
       "wrap fit() feeding in DeviceUploadIter (default: multi-core)"),
    _k("MXTPU_UPLOAD_DEPTH", "int", 2, "io",
       "device staging buffers ahead of the step"),
    _k("MXTPU_UPLOAD_CHUNKS", "int", 1, "io",
       "chunked async device_puts per host batch"),
    _k("MXTPU_DECODE_START_METHOD", "str", None, "io",
       "multiprocessing start method for decode workers"),
    # --- quantization --------------------------------------------------
    _k("MXTPU_QUANT_MODE", "str", "minmax", "quant",
       "activation calibration mode: minmax|percentile"),
    _k("MXTPU_QUANT_PERCENTILE", "float", 99.9, "quant",
       "percentile of |x| per calibration batch (percentile mode)"),
    # --- serving -----------------------------------------------------------
    _k("MXTPU_SERVE_BUCKETS", "list", [1, 4, 8, 16, 32], "serving",
       "AOT batch bucket ladder (comma ints)"),
    _k("MXTPU_SERVE_MAX_WAIT_US", "int", 2000, "serving",
       "head-of-queue coalescing wait"),
    _k("MXTPU_SERVE_CAP", "int", None, "serving",
       "dispatch row cap (default: largest bucket)"),
    _k("MXTPU_SERVE_TIMEOUT_MS", "int", 10000, "serving",
       "per-request deadline (0 = off)"),
    _k("MXTPU_SERVE_VALIDATE", "bool", True, "serving",
       "per-request output finiteness check"),
    _k("MXTPU_SERVE_QUEUE_CAP", "int", 4096, "serving",
       "admission-control queue bound in rows (0 = off)"),
    _k("MXTPU_SERVE_SHED_POLICY", "str", "reject", "serving",
       "reject|block past queue_cap"),
    _k("MXTPU_SERVE_BREAKER_K", "int", 5, "serving",
       "consecutive batch failures that open the breaker (0 = off)"),
    _k("MXTPU_SERVE_BREAKER_COOLDOWN_MS", "int", 1000, "serving",
       "breaker cool-down before the half-open probe"),
    _k("MXTPU_SERVE_DRAIN_S", "float", 0.0, "serving",
       "stop() drain budget for queued work"),
    _k("MXTPU_SERVE_SLOW_S", "float", 0.05, "serving",
       "injected slow_request stall"),
    _k("MXTPU_SERVE_PRECISION", "str", "auto", "serving",
       "tenant precision tier: auto|float32|bfloat16|int8 "
       "(int8 requires a quantized symbol; see quantization.md)"),
    _k("MXTPU_SERVE_MEM_BUDGET", "int", 0, "serving",
       "per-chip byte budget for memory-aware tenant admission "
       "(0 = off; predicted weights + worst-bucket peak must fit)"),
    _k("MXTPU_SERVE_PACE_RPS", "float", 0.0, "serving",
       "per-replica service pacing in rows/s (0 = off) — emulates a "
       "fixed per-chip capacity for fleet drills on the CPU tier"),
    _k("MXTPU_FAULTS", "str", None, "faults", "fault-injection spec"),
    # --- faults / launch ---------------------------------------------------
    _k("MXTPU_HEARTBEAT_DIR", "str", None, "health",
       "shared heartbeat dir"),
    _k("MXTPU_HEARTBEAT_TRANSPORT", "str", "dir", "health",
       "dir|kv heartbeat transport"),
    _k("MXTPU_ELASTIC", "bool", False, "elastic",
       "elastic worker flag (set by tools/launch.py --local-elastic)"),
    _k("MXTPU_ELASTIC_DIR", "str", None, "elastic",
       "shared membership dir"),
    _k("MXTPU_ELASTIC_CHECK_S", "float", None, "elastic",
       "monitor scan period"),
    _k("MXTPU_ELASTIC_HB_TIMEOUT_S", "float", None, "elastic",
       "liveness timeout"),
    _k("MXTPU_ELASTIC_JOIN_GRACE_S", "float", None, "elastic",
       "never-stamped rank grace"),
    _k("MXTPU_ELASTIC_STEP_TIMEOUT_S", "float", None, "elastic",
       "collective-entry guard wait"),
    _k("MXTPU_COMM_PARITY", "bool", True, "elastic",
       "cross-rank comm-plan digest check"),
    _k("MXTPU_COMM_PARITY_TIMEOUT_S", "float", None, "elastic",
       "bounded wait for peer plan stamps"),
    _k("MXTPU_INIT_ATTEMPTS", "int", None, "distributed",
       "jax.distributed.initialize retries"),
    _k("MXTPU_INIT_TIMEOUT_S", "float", None, "distributed",
       "jax.distributed.initialize hard timeout"),
    _k("MXTPU_COORDINATOR", "str", None, "distributed",
       "coordinator address (set by tools/launch.py)"),
    _k("MXTPU_NUM_PROCESSES", "int", None, "distributed",
       "world size (set by tools/launch.py)"),
    _k("MXTPU_PROCESS_ID", "int", None, "distributed",
       "rank (set by tools/launch.py)"),
    _k("MXTPU_OBS", "bool", False, "obs", "arm the span recorder"),
    # --- observability / sanitizers ----------------------------------------
    _k("MXTPU_OBS_LOG", "str", None, "obs", "JSONL span/metric log"),
    _k("MXTPU_OBS_FLUSH_S", "float", None, "obs", "exporter period"),
    _k("MXTPU_TSAN", "bool", False, "tsan", "lockset race recorder"),
    _k("MXTPU_TSAN_LOG", "str", None, "tsan", "TSAN event JSONL"),
    _k("MXTPU_TSAN_STACK", "bool", False, "tsan",
       "record acquisition stacks"),
))


def declared(name: str) -> bool:
    return name in KNOBS


def is_set(name: str) -> bool:
    """The env layer of knob resolution: set AND non-empty (an empty
    export is 'unset' everywhere in this codebase)."""
    return bool(os.environ.get(name))


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw string value (or ``default`` when unset/empty)."""
    v = os.environ.get(name)
    return v if v else default


def _parse_int(name, v):
    try:
        return int(v)
    except (TypeError, ValueError):
        raise MXNetError("%s=%r is not an integer" % (name, v)) from None


def _parse_float(name, v):
    try:
        return float(v)
    except (TypeError, ValueError):
        raise MXNetError("%s=%r is not a number" % (name, v)) from None


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _parse_bool(name, v):
    low = str(v).strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise MXNetError("%s=%r is not a boolean (use 0/1)" % (name, v))


def get_int(name: str, default=None):
    v = os.environ.get(name)
    if not v:
        return default
    return _parse_int(name, v)


def get_float(name: str, default=None):
    v = os.environ.get(name)
    if not v:
        return default
    return _parse_float(name, v)


def get_bool(name: str, default=None):
    v = os.environ.get(name)
    if not v:
        return default
    return _parse_bool(name, v)


def get_str(name: str, default=None):
    return raw(name, default)


def _check_value(knob: _Knob, v: str) -> Optional[str]:
    """Type-check a SET value against its declared kind; returns an
    error string or None."""
    try:
        if knob.kind == "int":
            _parse_int(knob.name, v)
        elif knob.kind == "float":
            _parse_float(knob.name, v)
        elif knob.kind == "bool":
            _parse_bool(knob.name, v)
        elif knob.kind == "list":
            try:
                [int(x) for x in v.split(",") if x]
            except ValueError:
                raise MXNetError(
                    "%s=%r is not a comma-separated integer list"
                    % (knob.name, v)) from None
    except MXNetError as e:
        return str(e)
    return None


def validate_environ(environ=None,
                     strict: Optional[bool] = None
                     ) -> List[Tuple[str, str]]:
    """Scan ``environ`` for ``MXTPU_*`` names no code reads and for set
    knobs whose values don't parse as their declared type.  Returns
    ``[(name, message), ...]`` and warns (:class:`KnobWarning`) per
    finding; with ``strict`` (or ``MXTPU_STRICT_KNOBS=1``) raises
    :class:`MXNetError` on the first finding instead — a typo'd knob
    like ``MXTPU_GRAD_ACUM=4`` must never silently configure nothing.
    """
    import difflib
    env = os.environ if environ is None else environ
    if strict is None:
        strict = str(env.get("MXTPU_STRICT_KNOBS", "")).lower() in _TRUE
    findings: List[Tuple[str, str]] = []
    for name in sorted(env):
        if not name.startswith("MXTPU_"):
            continue
        if name not in KNOBS:
            close = difflib.get_close_matches(name, sorted(KNOBS), n=1)
            msg = ("unknown env knob %s — no mxnet_tpu_torch code reads it%s"
                   % (name, (" (did you mean %s?)" % close[0])
                      if close else ""))
            findings.append((name, msg))
            continue
        err = _check_value(KNOBS[name], env[name])
        if err:
            findings.append((name, err))
    for name, msg in findings:
        if strict:
            raise MXNetError(msg + " (MXTPU_STRICT_KNOBS=1)")
        warnings.warn(msg, KnobWarning, stacklevel=2)
    return findings
