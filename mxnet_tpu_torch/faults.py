"""Deterministic fault injection (``MXTPU_FAULTS``), the port of
``mxnet_tpu/faults.py``.

Every recovery path is drivable on demand from a small declarative
spec, so a test can assert "the poisoned request failed alone" or "the
breaker opened" in milliseconds instead of trusting the code on faith.

Spec grammar (``MXTPU_FAULTS`` or :func:`configure`)::

    spec      := directive (";" directive)*
    directive := kind "@" item (":" item)*
    item      := key "=" int | key "=" word | bare-word

* ``kind`` names the fault (``nan_grad``, ``io_error``, ``crash``,
  ``host_dead``, ``hb_stall``, ...).
* A ``key=int`` item is a threshold on a counter the injection site
  reports (``step=3`` arms once the site's ``step`` reaches 3) —
  except ``rank``, which matches EXACTLY (a rank is an identity, not a
  counter: ``host_dead@step=3:rank=1`` must kill rank 1, not every
  rank >= 1).
* A ``key=word`` item names a STRING identity and matches EXACTLY
  against the site's context value (``batch_error@model=ranker`` fails
  only that tenant's batches).  Only declared identity keys
  (``model``) take strings — a typo'd integer value is still a parse
  error, not a directive that silently never fires.
* A bare word must equal the site's ``site=`` context value
  (``crash@ckpt_write`` fires at the checkpoint-write site).
* ``count=N`` fires the directive on its first N armed hits
  (default 1) — e.g. ``io_error@batch=5:count=2`` fails the batch-5
  fetch twice, so a 3-attempt retry loop recovers and a 2-attempt one
  does not.

Injection sites of the port (each passes its own counters; all are
no-ops when no spec is installed), those of ``serving/server.py``:

* ``slow_request`` / ``poison_request`` — ``request=`` is the server's
  1-based request counter.  A slow request sleeps
  ``MXTPU_SERVE_SLOW_S`` during batch assembly (a slow payload
  deserialize — its batch's latency spikes, the queue behind it keeps
  coalescing); a poisoned request has its payload NaN-filled,
  exercising per-request error isolation: the output-finiteness check
  fails THAT future, the rest of the batch completes.
* ``batch_error`` — the serving scheduler.  With ``model=NAME``
  (exact string match) the named tenant's next ``count=K`` dispatched
  batches raise inside ``_run_batch`` — the whole-batch failure that
  feeds the per-model circuit breaker (K consecutive failures open
  it).  With the bare site word ``sched`` (``batch_error@sched``) the
  exception is raised in the scheduler LOOP itself, outside the
  per-batch recovery — driving the supervision path: every pending
  future fails, the server flips to rejecting.

Those of training and its persistence:

* ``io_error`` — ``DataIter.__next__`` (``site=iter_next``); ``batch=``
  counts the batches the iterator delivered over its life, so a failed
  fetch keeps its index and ``fit``'s bounded retry
  (``resilience.retry_io``) asks again for the batch it never got.
* ``crash`` — the checkpoint commits: ``ckpt_write`` between a params
  file's write and its rename (``save=`` is the process's 1-based count
  of such saves, ``model._atomic_save``), ``manifest_write`` between a
  manifest's write and its rename (``epoch=``).  The process dies as
  SIGKILL would (``os._exit(137)``), or with the ``soft`` flag raises
  :class:`InjectedCrash`; either way the ``.tmp`` stays behind and the
  previous version stays visible.

And those of the fused trainer, the heartbeats and elastic
membership:

* ``nan_grad`` — :meth:`Trainer.step <mxnet_tpu_torch.parallel.trainer.
  Trainer.step>` poisons the first floating input with NaN (``step=`` is
  the 1-based update counter), so the sentinel's skip or abort runs.
* ``host_dead`` — the elastic guard (``elastic.ElasticCoordinator.
  guard``, before the step barrier's stamp), and ``Trainer.step`` for a
  run without a coordinator (before the step's collectives): the
  targeted rank dies as SIGKILL would (``os._exit(137)``).  ``step=`` is
  the update counter, ``rank=`` matches exactly.  Drives the membership
  shrink and the resume.
* ``hb_stall`` — ``health.Heartbeat``'s thread (``site=hb_stamp``,
  ``beat=``, ``rank=`` exact) freezes without the process dying: the
  split brain, where peers declare the rank dead and it must see its
  own revocation.
* ``bitflip`` — ``Trainer.step`` after the update (``step=``, ``rank=``
  the exact rank on the data axis): one bit of a float32 state leaf
  flipped on that rank's copy, a quiet corruption the sentinel cannot
  see, which drives the integrity vote, audit and rollback.  Payload
  keys, carried to the site and never matched: ``leaf=GLOB`` (a state
  path, ``arg/fc1_weight``, ``opt/fc1_weight[0]`` or the bare name;
  only ``*``/``?`` are wildcards, and ``/`` spells the namespace colon,
  since ``:`` separates conditions; default ``*``, the first leaf) and
  ``bit=B`` (default 12, in the mantissa).

The grammar, the condition keys, the site words and the sites are the
JAX package's (``mxnet_tpu/faults.py``), so one spec parses to the same
directives and fires at the same places in both packages, each
directive once per process for each of its ``count``.

Condition keys are CHECKED at parse time against the registry of keys
the injection sites actually report (`_KNOWN_KEYS`): a typo like
``setp=3`` is a loud parse error naming the key, not a directive that
silently never fires.

Example::

    MXTPU_FAULTS="nan_grad@step=3;io_error@batch=5:count=2;crash@ckpt_write"
    MXTPU_FAULTS="poison_request@request=7;slow_request@request=12:count=3"
    MXTPU_FAULTS="batch_error@model=ranker:count=5"
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import _tsan
from .base import MXNetError

__all__ = ["configure", "clear", "active", "hit", "hit_params",
           "maybe_crash", "fired", "injected", "InjectedCrash"]

_ENV = "MXTPU_FAULTS"

# condition keys that name an IDENTITY rather than a counter: matched
# exactly, not as a >= threshold (killing "rank 1" must not also kill
# rank 2)
_EXACT_KEYS = frozenset(("rank",))

# identity keys whose values are STRINGS (matched exactly); every other
# key still requires an integer — "io_error@batch=soon" stays a parse
# error, not a directive that silently never fires
_STRING_KEYS = frozenset(("model", "leaf"))

# payload keys: carried TO the site on a fire (hit_params) instead of
# being matched against it — the bitflip directive's target selection.
# Scoped per kind: a payload key on any OTHER kind is a parse error
# (it could never be matched NOR delivered — exactly the class of
# silently-inert condition the _KNOWN_KEYS check exists to catch)
_PARAM_KEYS = frozenset(("leaf", "bit"))
_PARAM_KEYS_BY_KIND = {"bitflip": _PARAM_KEYS}

# every condition key some injection site actually reports (plus the
# grammar's own count/payload keys).  _parse REJECTS anything else:
# "setp=3" must be a loud error naming the key, not a directive that
# silently never fires.
_KNOWN_KEYS = frozenset((
    "step", "batch", "beat", "save", "epoch", "request", "rank",
    "model", "count", "leaf", "bit"))

# every bare site word an injection site actually reports (``site=``
# ctx).  _parse REJECTS anything else for the same reason as
# _KNOWN_KEYS — in particular the tail of ``leaf=arg:fc1_weight``,
# where ':' splits the namespaced leaf path into a bogus site word and
# the directive would otherwise silently never fire.
_KNOWN_SITES = frozenset((
    "iter_next", "hb_stamp", "ckpt_write", "manifest_write",
    "decode_worker", "sched"))


class InjectedCrash(BaseException):
    """Raised instead of ``os._exit`` when a crash directive carries the
    ``soft`` flag — lets a single-process test observe the torn state
    without dying.  Derives from BaseException so ordinary ``except
    Exception`` recovery code cannot accidentally swallow the "kill"."""


class _Directive:
    __slots__ = ("kind", "conds", "sites", "count", "soft", "fired")

    def __init__(self, kind: str, conds: Dict[str, int], sites: List[str],
                 count: int, soft: bool):
        self.kind = kind
        self.conds = conds
        self.sites = sites
        self.count = count
        self.soft = soft
        self.fired = 0

    def matches(self, ctx: Dict) -> bool:
        if self.fired >= self.count:
            return False
        for site in self.sites:
            if ctx.get("site") != site:
                return False
        for key, threshold in self.conds.items():
            if key in _PARAM_KEYS:
                continue            # payload, delivered on fire
            val = ctx.get(key)
            if val is None:
                return False
            if isinstance(threshold, str):
                # identity string (model=NAME): exact match
                if str(val) != threshold:
                    return False
            elif key in _EXACT_KEYS:
                if int(val) != threshold:
                    return False
            elif int(val) < threshold:
                return False
        return True


def _parse(spec: str) -> List[_Directive]:
    out = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, sep, rest = raw.partition("@")
        kind = kind.strip()
        if not sep or not kind or not rest.strip():
            raise MXNetError(
                "bad fault directive %r (want kind@cond[:cond...], e.g. "
                "nan_grad@step=3)" % raw)
        conds, sites, count, soft = {}, [], 1, False
        for item in rest.split(":"):
            item = item.strip()
            if not item:
                continue
            key, eq, val = item.partition("=")
            if eq:
                if key not in _KNOWN_KEYS:
                    import difflib
                    close = difflib.get_close_matches(
                        key, sorted(_KNOWN_KEYS), n=1)
                    raise MXNetError(
                        "unknown fault condition key %r in %r%s — known "
                        "keys: %s (a typo'd key would otherwise never "
                        "fire)" % (key, raw,
                                   (" (did you mean %r?)" % close[0])
                                   if close else "",
                                   "/".join(sorted(_KNOWN_KEYS))))
                if key in _STRING_KEYS:
                    # an identity string, matched exactly — checked
                    # BEFORE int() so a tenant literally named "2"
                    # stays a string, not a threshold
                    conds[key] = val.strip()
                    continue
                try:
                    ival = int(val)
                except ValueError:
                    raise MXNetError(
                        "bad fault condition %r in %r (values are "
                        "integers; string identities: %s)"
                        % (item, raw,
                           "/".join(sorted(_STRING_KEYS)))) from None
                if key == "count":
                    count = ival
                else:
                    conds[key] = ival
            elif item == "soft":
                soft = True
            elif item not in _KNOWN_SITES:
                hint = ""
                if any(k in _STRING_KEYS for k in conds):
                    hint = (" — ':' separates conditions; inside a "
                            "leaf glob spell the namespace colon as "
                            "'/' (leaf=arg/fc1_weight) or use the "
                            "bare leaf name")
                raise MXNetError(
                    "unknown fault site word %r in %r%s (known sites: "
                    "%s; an unknown site would otherwise never fire)"
                    % (item, raw, hint, "/".join(sorted(_KNOWN_SITES))))
            else:
                sites.append(item)
        allowed_payload = _PARAM_KEYS_BY_KIND.get(kind, frozenset())
        for key in conds:
            if key in _PARAM_KEYS and key not in allowed_payload:
                raise MXNetError(
                    "condition key %r in %r is a payload key of %s "
                    "directives only — on %r it would neither match nor "
                    "be delivered" % (key, raw,
                                      "/".join(sorted(_PARAM_KEYS_BY_KIND)),
                                      kind))
        out.append(_Directive(kind, conds, sites, count, soft))
    return out


_lock = _tsan.lock("faults._lock")
_directives: List[_Directive] = []
_configured = False        # explicit configure() beats the env
_ACTIVE = False            # lock-free fast-path flag for hot sites


def configure(spec: Optional[str] = None) -> None:
    """Install a fault spec (``None`` re-reads ``MXTPU_FAULTS``)."""
    global _directives, _configured, _ACTIVE
    if spec is None:
        spec = os.environ.get(_ENV, "")
    with _lock:
        _directives = _parse(spec)
        _configured = True
        _ACTIVE = bool(_directives)


def clear() -> None:
    """Remove every directive (and forget the env spec)."""
    global _directives, _configured, _ACTIVE
    with _lock:
        _directives = []
        _configured = True
        _ACTIVE = False


def _ensure_loaded() -> None:
    global _ACTIVE
    if not _configured:
        configure(None)


def active(kind: Optional[str] = None) -> bool:
    """Whether any (or any ``kind``) directive is installed and unspent."""
    _ensure_loaded()
    with _lock:
        return any((kind is None or d.kind == kind) and d.fired < d.count
                   for d in _directives)


def hit(kind: str, **ctx) -> bool:
    """Report reaching an injection site.  Returns True exactly when a
    matching directive fires (and consumes one of its ``count``)."""
    return hit_params(kind, **ctx) is not None


def hit_params(kind: str, **ctx) -> Optional[Dict]:
    """Like :func:`hit`, but on a fire returns the directive's PAYLOAD
    keys (``leaf=``/``bit=`` — carried to the site, never matched) so
    the site knows what to corrupt.  ``{}`` means "fired, no payload";
    ``None`` means no directive fired."""
    if not _ACTIVE and _configured:
        return None
    _ensure_loaded()
    with _lock:
        for d in _directives:
            if d.kind == kind and d.matches(ctx):
                d.fired += 1
                return {k: v for k, v in d.conds.items()
                        if k in _PARAM_KEYS}
    return None


def fired(kind: str) -> int:
    """Total fires of ``kind`` so far (test observability)."""
    _ensure_loaded()
    with _lock:
        return sum(d.fired for d in _directives if d.kind == kind)


def maybe_crash(site: str, **ctx) -> None:
    """Crash-injection helper for write sites: on a matching ``crash``
    directive, die like SIGKILL (``os._exit(137)`` — no atexit, no
    buffered-IO flush) or raise :class:`InjectedCrash` for ``soft``
    directives."""
    if not _ACTIVE and _configured:
        return
    _ensure_loaded()
    with _lock:
        firing = None
        for d in _directives:
            if d.kind == "crash" and d.matches(dict(ctx, site=site)):
                d.fired += 1
                firing = d
                break
    if firing is None:
        return
    if firing.soft:
        raise InjectedCrash("injected crash at %s" % site)
    os._exit(137)


class injected:
    """``with faults.injected("nan_grad@step=3"): ...`` — scoped spec
    for tests; restores the previous directives on exit."""

    def __init__(self, spec: str):
        self.spec = spec
        self._saved = None

    def __enter__(self):
        global _directives, _configured, _ACTIVE
        _ensure_loaded()
        with _lock:
            self._saved = (_directives, _configured, _ACTIVE)
        configure(self.spec)
        return self

    def __exit__(self, *exc):
        global _directives, _configured, _ACTIVE
        with _lock:
            _directives, _configured, _ACTIVE = self._saved
        return False
