"""Crash-consistent checkpoints and auto-resume (``mxnet_tpu/resilience.py``).

``model._atomic_save`` already keeps a torn params file from ever being
visible; this module adds the rest of the contract:

* :class:`CheckpointManager`: every save is stamped with a JSON manifest
  that records the CRC32 and size of each artifact (symbol, params,
  optimizer states), the step and epoch, and the random stream's kind.
  The manifest is written last, atomically: its presence commits the
  save.  A crash at any earlier point leaves a ``*.tmp`` (swept by the
  resume scan) or a params file without a manifest (ignored by it),
  never a checkpoint that loads wrong.
* :meth:`CheckpointManager.latest`: the newest checkpoint whose every
  artifact still matches its manifest, walking back past truncated,
  corrupt or uncommitted saves.
* :meth:`CheckpointManager.latest_verified`: the silent-data-corruption
  tier above it.  Every save also records the state fingerprint the
  device computed (``integrity.py``; ``Module.state_fingerprint``), and
  this scan re-hashes the loaded values against it: the CRC guards the
  bytes from the moment they landed, the fingerprint the values from
  the moment the card held them.  It is the rollback target of
  ``fit``'s integrity recovery, and retention never deletes the newest
  checkpoint that passes it.
* :func:`retry_io`: bounded retry with decorrelated-jitter backoff for
  transient input and checkpoint I/O failures, used by ``fit``'s batch
  fetch and by every manager write.

The manifest format is the JAX package's, so a manifest, its params
file and its integrity record cross packages both ways.  ``rng.impl``
names the port's streams (one ``torch.Generator`` per device, whose
state the fused trainer carries in its optimizer-state blob).  The
optimizer-state files do not cross packages, so a record the JAX
package wrote (``rng.impl`` not the port's) is checked here leaf by
leaf on its ``arg:`` and ``aux:`` leaves, and its ``opt:`` leaves are
logged by name as not checked.

``BaseModule.fit(..., checkpoint=prefix, resume=True)`` wires it into
the training loop: a killed run started again with the same arguments
continues from the newest intact checkpoint and, with a deterministic
iterator, reproduces the uninterrupted run's parameters bit for bit.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import random
import time
import zlib
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["CheckpointManager", "Checkpoint", "retry_io"]

_MANIFEST_VERSION = 1

# the port's random streams, recorded in each manifest
RNG_IMPL = "torch.Generator per device; its state in the states blob"


def retry_io(fn: Callable, attempts: int = 3, delay: float = 0.05,
             backoff: float = 2.0, jitter: float = 0.1,
             exceptions: Tuple = (OSError,), what: str = "io",
             logger=logging, rng=None):
    """``fn()`` with up to ``attempts`` tries, sleeping about
    ``delay * backoff**k`` between failures of the ``exceptions``
    classes; the last failure re-raises.  ``StopIteration`` and other
    exceptions pass at once: an exhausted iterator or a logic error is
    not a transient fault.

    ``jitter`` is decorrelated: each sleep is the previous actual sleep
    times ``backoff``, perturbed by a uniform +-``jitter`` fraction, so
    ranks that failed together drift apart.  ``rng`` (a
    ``random.Random``) pins the sequence; ``jitter=0`` disables it."""
    attempts = max(1, int(attempts))
    wait = None
    for attempt in range(attempts):
        try:
            return fn()
        except exceptions as e:
            if attempt + 1 >= attempts:
                raise
            wait = delay if wait is None else wait * backoff
            if jitter:
                if rng is None:
                    rng = random.Random()
                wait *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
            logger.warning("%s failed (attempt %d/%d): %s — retrying "
                           "in %.2fs", what, attempt + 1, attempts, e,
                           wait)
            time.sleep(wait)


def _crc32_file(path: str, chunk: int = 1 << 20) -> Tuple[int, int]:
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return crc & 0xFFFFFFFF, size


class Checkpoint:
    """One checkpoint on disk whose manifest checked out."""

    def __init__(self, prefix: str, epoch: int, manifest: dict):
        self.prefix = prefix
        self.epoch = epoch
        self.manifest = manifest

    @property
    def step(self) -> Optional[int]:
        return self.manifest.get("step")

    @property
    def params_path(self) -> str:
        return "%s-%04d.params" % (self.prefix, self.epoch)

    @property
    def states_path(self) -> Optional[str]:
        path = "%s-%04d.states" % (self.prefix, self.epoch)
        if os.path.basename(path) in self.manifest.get("files", {}):
            return path
        return None

    def load_params(self):
        """``(symbol, arg_params, aux_params)``, through
        :func:`mxnet_tpu_torch.model.load_checkpoint`."""
        from . import model as _model
        return _model.load_checkpoint(self.prefix, self.epoch)

    def __repr__(self):
        return "Checkpoint(prefix=%r, epoch=%d)" % (self.prefix,
                                                    self.epoch)


class CheckpointManager:
    """A CRC-manifested line of checkpoints under one ``prefix``.

    ``save`` writes ``prefix-symbol.json`` and ``prefix-NNNN.params``
    (and ``.states`` when the module's optimizer is initialized), then
    commits them with ``prefix-NNNN.manifest.json`` and prunes the saves
    beyond the newest ``keep``.  Writes go through :func:`retry_io`;
    a failed verification is never retried (a bad CRC is damage)."""

    def __init__(self, prefix: str, keep: int = 3, attempts: int = 3,
                 delay: float = 0.05, logger=None):
        self.prefix = str(prefix)
        self.keep = int(keep)
        self.attempts = int(attempts)
        self.delay = float(delay)
        self.logger = logger or logging.getLogger("mxtpu.resilience")
        # epoch -> (on-disk identity, verdict): a poll between saves
        # re-reads no checkpoint bytes; any change of the manifest or of
        # an artifact's mtime or size drops the entry
        self._vcache = {}
        parent = os.path.dirname(os.path.abspath(self.prefix))
        if parent:
            os.makedirs(parent, exist_ok=True)

    # ------------------------------------------------------------- save
    def _manifest_path(self, epoch: int) -> str:
        return "%s-%04d.manifest.json" % (self.prefix, epoch)

    def _retry(self, fn, what):
        return retry_io(fn, attempts=self.attempts, delay=self.delay,
                        what=what, logger=self.logger)

    def save(self, module, epoch: int, arg_params=None, aux_params=None,
             extra_manifest=None):
        """Checkpoint ``module`` as epoch ``epoch`` (the number of
        completed epochs, as ``callback.do_checkpoint`` counts).
        ``extra_manifest`` adds keys of its own to the manifest (the
        manifest's own keys win)."""
        from .model import _commit_file, save_checkpoint
        if arg_params is None or aux_params is None:
            arg_params, aux_params = module.get_params()
        self._retry(
            lambda: save_checkpoint(self.prefix, epoch, module.symbol,
                                    arg_params, aux_params),
            "checkpoint params write")
        files = {}
        params_file = "%s-%04d.params" % (self.prefix, epoch)
        states_file = "%s-%04d.states" % (self.prefix, epoch)
        symbol_file = "%s-symbol.json" % self.prefix
        if getattr(module, "optimizer_initialized", False):
            # durable before the manifest names it, as the params are
            self._retry(lambda: _commit_file(states_file,
                                             module.save_optimizer_states),
                        "optimizer state write")
            files[os.path.basename(states_file)] = self._entry(states_file)
        files[os.path.basename(params_file)] = self._entry(params_file)
        if os.path.exists(symbol_file):
            # shared by every epoch, but load_checkpoint reads it: a torn
            # or swapped symbol must fail verification, not load
            files[os.path.basename(symbol_file)] = self._entry(symbol_file)
        trainer = getattr(module, "_trainer", None)
        # the fingerprint the device computed: what the card held at save
        # time, hashed before the host and the disk could change it
        integ = None
        fp = getattr(module, "state_fingerprint", None)
        if callable(fp):
            from .integrity import IntegrityError
            try:
                integ = fp()
            except IntegrityError as e:
                # the replicas disagree on the state being saved: an
                # explicit refusal, which never verifies (a missing record
                # verifies vacuously)
                integ = {"refused": str(e)}
                self.logger.warning(
                    "checkpoint %04d: state DIVERGED at save — "
                    "deliberately left unverified (CRC-manifested "
                    "only); the next integrity check will roll back "
                    "past it: %s", epoch, e)
            except Exception as e:                  # noqa: BLE001
                self.logger.warning(
                    "checkpoint %04d: state fingerprint unavailable "
                    "(%s) — save still CRC-manifested, but it cannot "
                    "pass latest_verified()", epoch, e)
        manifest = dict(extra_manifest or {})
        manifest.update({
            "version": _MANIFEST_VERSION,
            "epoch": int(epoch),
            "step": int(trainer.num_update) if trainer is not None
            else None,
            "sentinel_skips": trainer.sentinel_skips
            if trainer is not None else None,
            "trainer": None if trainer is None else {
                "zero": trainer.zero,
                "grad_accum": trainer.grad_accum,
                "grad_dtype": trainer.grad_dtype,
            },
            "rng": {"impl": RNG_IMPL},
            "wallclock": time.time(),
            "files": files,
            "integrity": integ,
        })
        self._retry(lambda: self._write_manifest(epoch, manifest),
                    "manifest write")
        self._prune()
        return Checkpoint(self.prefix, epoch, manifest)

    @staticmethod
    def _entry(path):
        crc, size = _crc32_file(path)
        return {"crc32": crc, "size": size}

    def _write_manifest(self, epoch: int, manifest: dict):
        """The commit record, through the same fsync'd tmp and rename as
        the artifacts it commits."""
        from .model import _commit_file

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)

        _commit_file(self._manifest_path(epoch), write,
                     crash_site="manifest_write", epoch=epoch)

    # ------------------------------------------------------------- scan
    def _epochs_on_disk(self) -> Sequence[int]:
        out = []
        for path in glob.glob(glob.escape(self.prefix)
                              + "-[0-9][0-9][0-9][0-9].manifest.json"):
            try:
                out.append(int(path[-len("0000.manifest.json"):
                                    -len(".manifest.json")]))
            except ValueError:
                pass
        return sorted(out)

    def verify(self, epoch: int) -> Optional[Checkpoint]:
        """The checkpoint of ``epoch`` if every artifact matches its
        manifest, else None (the reason logged)."""
        path = self._manifest_path(epoch)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            self.logger.warning("skipping checkpoint %04d: manifest "
                                "unreadable (%s)", epoch, e)
            return None
        for name, meta in manifest.get("files", {}).items():
            full = os.path.join(os.path.dirname(os.path.abspath(path)),
                                name)
            try:
                crc, size = _crc32_file(full)
            except OSError as e:
                self.logger.warning("skipping checkpoint %04d: %s "
                                    "unreadable (%s)", epoch, name, e)
                return None
            if size != meta.get("size") or crc != meta.get("crc32"):
                self.logger.warning(
                    "skipping checkpoint %04d: %s fails verification "
                    "(size %d vs %s, crc %08x vs %s)", epoch, name,
                    size, meta.get("size"), crc,
                    ("%08x" % meta["crc32"]) if "crc32" in meta else "?")
                return None
        return Checkpoint(self.prefix, epoch, manifest)

    def latest(self) -> Optional[Checkpoint]:
        """The newest checkpoint that verifies, after sweeping the
        ``*.tmp`` leftovers of crashed saves."""
        from .model import _sweep_stale_tmp
        _sweep_stale_tmp(self.prefix)
        for epoch in reversed(self._epochs_on_disk()):
            ck = self.verify(epoch)
            if ck is not None:
                return ck
        return None

    def verify_fingerprint(self, ck: Checkpoint) -> bool:
        """Re-hash ``ck``'s loaded values against the fingerprint its
        manifest recorded at save time.  The params and aux states come
        from the params file, the ``opt:`` leaves from the fused
        trainer's states blob.  A manifest without a record verifies
        vacuously (absent evidence is not damage); a ``refused`` record
        never verifies.  A record the JAX package wrote is checked on its
        ``arg:`` and ``aux:`` leaves (:meth:`_verify_foreign`)."""
        from . import integrity as _integrity
        record = (ck.manifest or {}).get("integrity")
        if not record:
            return True
        if record.get("refused"):
            self.logger.warning(
                "checkpoint %04d recorded a REFUSED fingerprint (state "
                "diverged at save): %s", ck.epoch, record["refused"])
            return False
        try:
            _, arg_params, aux_params = ck.load_params()
        except Exception as e:                      # noqa: BLE001
            self.logger.warning(
                "checkpoint %04d fails fingerprint verification: params "
                "unreadable (%s)", ck.epoch, e)
            return False
        named = _integrity.named_state_leaves(
            {n: v.asnumpy() for n, v in arg_params.items()},
            {n: v.asnumpy() for n, v in aux_params.items()})
        opt_paths = sorted(p for p in record.get("leaves", {})
                           if p.startswith("opt:"))
        foreign = ((ck.manifest or {}).get("rng") or {}).get("impl") \
            != RNG_IMPL
        if foreign and opt_paths and record.get("algo") == _integrity.ALGO:
            return self._verify_foreign(ck, record, named, opt_paths)
        if opt_paths:
            states = ck.states_path
            if states is None:
                self.logger.warning(
                    "checkpoint %04d fails fingerprint verification: "
                    "manifest records opt-state fingerprints but no "
                    "states file", ck.epoch)
                return False
            try:
                import pickle
                with open(states, "rb") as f:
                    state = pickle.loads(f.read())[1]
                named += _integrity.named_state_leaves(opt_state=state)
            except Exception as e:                  # noqa: BLE001
                self.logger.warning(
                    "checkpoint %04d fails fingerprint verification: "
                    "states blob unreadable (%s)", ck.epoch, e)
                return False
        return _integrity.verify_manifest_record(
            record, named, logger=self.logger,
            what="checkpoint %04d" % ck.epoch)

    def _verify_foreign(self, ck, record, named, opt_paths) -> bool:
        """A record the JAX package wrote, over a state whose optimizer
        file does not load here: every ``arg:`` and ``aux:`` leaf of the
        params file against the record's per-leaf values (the global
        fold needs the ``opt:`` leaves too); the ``opt:`` leaves are
        logged by name as not checked."""
        from . import integrity as _integrity
        from . import obs as _obs
        want = record.get("leaves", {})
        _, got = _integrity.host_fingerprint(named)
        have = [p for p in want if not p.startswith("opt:")]
        bad = sorted(p for p, fp in got.items() if want.get(p) != fp)
        missing = sorted(set(have) - set(got))
        self.logger.warning(
            "checkpoint %04d: the JAX package's integrity record; its "
            "optimizer state does not load in the port, so %d opt: "
            "leaves are NOT re-hashed: %s", ck.epoch, len(opt_paths),
            opt_paths)
        if not bad and not missing:
            return True
        self.logger.warning(
            "checkpoint %04d fails fingerprint verification: diverging "
            "leaves %s%s", ck.epoch, bad,
            (", missing %s" % missing) if missing else "")
        _obs.counter("integrity.verify_failed").inc()
        return False

    def _verify_identity(self, epoch: int):
        """``(identity, manifest)`` of one epoch: the manifest by path,
        mtime, size and content digest, every listed artifact by mtime
        and size; ``(None, None)`` when a piece is unreadable."""
        path = self._manifest_path(epoch)
        try:
            st = os.stat(path)
            with open(path, "rb") as f:
                blob = f.read()
            manifest = json.loads(blob)
        except (OSError, ValueError):
            return None, None
        ident = [(path, st.st_mtime_ns, st.st_size,
                  hashlib.sha1(blob).hexdigest())]
        base = os.path.dirname(os.path.abspath(path))
        try:
            for name in sorted(manifest.get("files", {})):
                fst = os.stat(os.path.join(base, name))
                ident.append((name, fst.st_mtime_ns, fst.st_size))
        except OSError:
            return None, None
        return tuple(ident), manifest

    def verified(self, epoch: int) -> Optional[Checkpoint]:
        """Both tiers for one epoch, the verdict cached on the
        checkpoint's on-disk identity."""
        ident, manifest = self._verify_identity(epoch)
        if ident is None:
            self._vcache.pop(epoch, None)
            ck = self.verify(epoch)
            return ck if ck is not None \
                and self.verify_fingerprint(ck) else None
        cached = self._vcache.get(epoch)
        if cached is not None and cached[0] == ident:
            return Checkpoint(self.prefix, epoch, manifest) \
                if cached[1] else None
        ck = self.verify(epoch)
        ok = ck is not None and self.verify_fingerprint(ck)
        # re-pinned after the reads: a file swapped meanwhile is not
        # cached under the old identity
        ident2, _ = self._verify_identity(epoch)
        if ident2 == ident:
            self._vcache[epoch] = (ident, ok)
        return ck if ok else None

    def latest_verified(self) -> Optional[Checkpoint]:
        """The newest checkpoint that passes both tiers."""
        from .model import _sweep_stale_tmp
        _sweep_stale_tmp(self.prefix)
        for epoch in reversed(self._epochs_on_disk()):
            ck = self.verified(epoch)
            if ck is not None:
                return ck
        return None

    # ---------------------------------------------------------- prune
    def _prune(self):
        """Drop the saves older than the newest ``keep`` manifests,
        except the newest one that passes both tiers, which survives
        rotation so a line of damaged or corrupt saves cannot rotate out
        the last state anyone can roll back to."""
        if self.keep <= 0:
            return
        epochs = self._epochs_on_disk()
        doomed = epochs[:-self.keep]
        if not doomed:
            return
        protect = None
        for epoch in reversed(epochs):
            if self.verified(epoch) is not None:
                protect = epoch
                break
        for epoch in doomed:
            if epoch == protect:
                continue
            self._vcache.pop(epoch, None)
            for suffix in (".params", ".states", ".manifest.json"):
                path = "%s-%04d%s" % (self.prefix, epoch, suffix)
                try:
                    os.remove(path)
                except OSError:
                    pass

    # --------------------------------------------------------- restore
    def restore(self, module, ck: Optional[Checkpoint] = None
                ) -> Optional[Checkpoint]:
        """Load ``ck`` (by default :meth:`latest`) into a bound module:
        the params through ``set_params``, the optimizer state when both
        sides have one.  Returns the checkpoint used, or None."""
        ck = ck or self.latest()
        if ck is None:
            return None
        _, arg_params, aux_params = self._retry(ck.load_params,
                                                "checkpoint read")
        module.set_params(arg_params, aux_params)
        if ck.states_path and getattr(module, "optimizer_initialized",
                                      False):
            self._retry(lambda: module.load_optimizer_states(
                ck.states_path), "optimizer state read")
            saved = (ck.manifest or {}).get("trainer") or {}
            trainer = getattr(module, "_trainer", None)
            if trainer is not None and saved \
                    and saved.get("zero") != trainer.zero:
                self.logger.info(
                    "optimizer state saved with zero=%s restored into a "
                    "zero=%s run (the blob holds whole leaves)",
                    saved.get("zero"), trainer.zero)
        return ck
