"""Worker health: heartbeats and dead-node detection
(``mxnet_tpu/health.py``).

The reference reports worker liveness through ps-lite heartbeats
(``include/mxnet/kvstore.h:235-244`` ``get_num_dead_node``).  Collectives
are fail-stop, so recovery is detect, restart, reload a checkpoint; this
module is the detection half.

Two stamp transports, both scanned by :func:`dead_nodes` (a rank is
alive if EITHER stamp is fresh):

* **the process group's store** (when ``torch.distributed`` is
  initialised): the TCP store the ranks met through, in place of the JAX
  package's coordination-service client, under the same keys
  (``mxtpu/hb/<rank>``).
* **a shared directory** (``MXTPU_HEARTBEAT_DIR``, set by the local
  launcher): one ``hb-<rank>`` file a rank, in the JAX package's format,
  so either package reads the other's stamps.

Every stamp is ``"<wall-clock time> <sequence>"``.  Once a rank's
sequence has been seen, liveness is judged by its progress on the
scanner's own monotonic clock, so a skewed clock neither kills nor
revives a rank; a first sight (or a stamp without a sequence) falls
back to the wall-clock or mtime age.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

import torch

from . import _tsan
from . import faults as _faults

__all__ = ["Heartbeat", "dead_nodes", "rank_evidence", "heartbeat_dir"]

_DEFAULT_INTERVAL = 1.0
_KV_PREFIX = "mxtpu/hb/"

# every live Heartbeat, stopped at interpreter exit: the beat thread is
# daemonic (it can never keep a wedged trainer alive), but an explicit
# atexit stop also keeps a heartbeat from stamping "alive" while the
# process is mid-shutdown — the window where a restart orchestrator
# would otherwise wait a full timeout for the stamp to go stale
_live_beats = weakref.WeakSet()


def _stop_all_at_exit():
    for hb in list(_live_beats):
        try:
            hb.stop()
        except Exception:      # noqa: BLE001 — never block interpreter exit
            pass


atexit.register(_stop_all_at_exit)


def heartbeat_dir() -> Optional[str]:
    return os.environ.get("MXTPU_HEARTBEAT_DIR") or None


def _stamp_path(directory: str, rank: int, role: str = "") -> str:
    """Stamp file for ``rank`` under ``role``.  The empty role keeps
    the historical ``hb-<rank>`` names (training ranks); a named role
    (``role="serve"`` — fleet replicas) stamps ``hb-<role>-<rank>``, so
    a serving fleet and a co-resident training job can share one
    coordination directory without each other's scans counting (or
    blaming) the other population's ranks."""
    if role:
        return os.path.join(directory, "hb-%s-%d" % (role, rank))
    return os.path.join(directory, "hb-%d" % rank)


def _kv_key(rank: int, role: str = "") -> str:
    return _KV_PREFIX + ("%s-%d" % (role, rank) if role else str(rank))


class _StoreClient:
    """The process group's store with the two calls the stamps need."""

    def __init__(self, store):
        self.store = store

    def key_value_set(self, key, value, allow_overwrite=True):
        self.store.set(key, value)

    def key_value_get(self, key):
        """The value of ``key``, or None when no rank has set it (never
        blocks: the store's ``get`` would wait for the key)."""
        if not self.store.check([key]):
            return None
        return self.store.get(key).decode()


def _kv_client():
    """The process group's store, if this process has joined one (None
    otherwise)."""
    dist = torch.distributed
    try:
        if dist.is_available() and dist.is_initialized():
            return _StoreClient(dist.distributed_c10d._get_default_store())
    except Exception:              # noqa: BLE001 - no store: no transport
        pass
    return None


class Heartbeat:
    """Background stamper for one worker's liveness."""

    def __init__(self, rank: int, directory: Optional[str] = None,
                 interval: float = _DEFAULT_INTERVAL, role: str = ""):
        self.rank = rank
        self.role = role
        self.directory = directory or heartbeat_dir()
        self._kv = _kv_client()
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        self._beats = 0
        self._stalled = False
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
        if self.directory or self._kv is not None:
            try:
                # a transiently failing first stamp (full disk, flaky
                # NFS) must not kill construction: the beat thread keeps
                # retrying every interval
                self._beat()
            except Exception:              # noqa: BLE001
                pass
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="mxtpu-hb-%d" % rank)
            self._thread.start()
            _live_beats.add(self)

    @property
    def active(self) -> bool:
        return self._thread is not None

    @property
    def stalled(self) -> bool:
        """True once an injected ``hb_stall`` fault froze the stamper
        (the thread keeps running, the process keeps training — the
        split-brain shape: this rank WILL be declared dead)."""
        return self._stalled

    def _beat(self):
        # __init__ calls _beat once BEFORE Thread.start() (a happens-
        # before edge); afterwards only the beat thread runs it, so the
        # counter is single-writer
        self._beats += 1   # tsan: ok — ordered before Thread.start()
        if _faults.hit("hb_stall", site="hb_stamp", beat=self._beats,
                       rank=self.rank):
            # the split-brain fault: the stamper freezes but the process
            # lives on — peers will (correctly, per the liveness
            # contract) declare this rank dead
            self._stalled = True   # tsan: ok — monotonic one-way flag,
            #                        single-writer (the beat thread);
            #                        readers tolerate any staleness
        if self._stalled:
            return
        if _faults.hit("io_error", site="hb_stamp", beat=self._beats):
            raise OSError("injected io_error at heartbeat stamp %d"
                          % self._beats)
        # "<wall-clock> <sequence>": the sequence side is what scanners
        # on other hosts trust once they have seen it advance (clock-
        # skew tolerance); the wall-clock side keeps pre-seq scanners
        # and first observations working
        stamp = "%f %d" % (time.time(), self._beats)
        if self.directory:
            if _tsan.TSAN:
                _tsan.note_write(
                    "health.heartbeat_stamp", lockfree=True,
                    reason="single-writer stamp file; scanners tolerate "
                           "torn reads via mtime (liveness contract)")
            with open(_stamp_path(self.directory, self.rank,
                                  self.role), "w") as f:
                f.write(stamp + "\n")
        if self._kv is not None:
            self._kv.key_value_set(_kv_key(self.rank, self.role), stamp,
                                   allow_overwrite=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._beat()
            except Exception:      # noqa: BLE001 — OSError or a dead
                pass               # coordination service; keep trying

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None


def _parse_stamp(text: str):
    """``(wall, seq)`` from stamp content; either side may be None."""
    parts = text.split()
    wall = seq = None
    try:
        wall = float(parts[0])
    except (ValueError, IndexError):
        pass
    try:
        seq = int(parts[1])
    except (ValueError, IndexError):
        pass
    return wall, seq


def _file_stamps(directory: str, num_workers: int,
                 role: str = "") -> dict:
    """Per-rank ``(wall, seq)`` evidence from the stamp files.  A stamp
    caught mid-write (empty, truncated float, interleaved garbage) or
    one that cannot be opened still counts through its mtime — a rank
    must never be declared dead because the SCANNER hit a torn read;
    only a stamp with no readable evidence at all is skipped."""
    if _tsan.TSAN:
        _tsan.note_read(
            "health.heartbeat_stamp", lockfree=True,
            reason="single-writer stamp file; scanners tolerate torn "
                   "reads via mtime (liveness contract)")
    out = {}
    for rank in range(num_workers):
        path = _stamp_path(directory, rank, role)
        mtime = None
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            pass
        written = seq = None
        try:
            with open(path) as f:
                written, seq = _parse_stamp(f.read())
        except (OSError, ValueError):
            pass   # unreadable, partially written, or non-UTF-8 garbage
                   # (UnicodeDecodeError is a ValueError): mtime still
                   # counts — the scanner must never die on a torn read
        walls = [t for t in (mtime, written) if t is not None]
        if walls or seq is not None:
            out[rank] = (max(walls) if walls else None, seq)
    return out


def _kv_stamps(client, num_workers: int, role: str = "") -> dict:
    """Per-rank ``(wall, seq)`` from the store (which lists no keys, so
    each rank's key is asked for; a scan counts only its role's)."""
    out = {}
    for rank in range(num_workers):
        try:
            value = client.key_value_get(_kv_key(rank, role))
        except Exception:          # noqa: BLE001 - store down: no evidence
            return out
        if value is None:
            continue
        wall, seq = _parse_stamp(value)
        if wall is not None or seq is not None:
            out[rank] = (wall, seq)
    return out


# sequence-progress memory: (transport key, rank) -> (last seq seen,
# scanner-monotonic time when that value was FIRST seen, wall-clock age
# of the stamp AT that first sight — the baseline that keeps a stale
# file discovered mid-life from reading as "fresh for one timeout").
# Guarded by a lock: dead_nodes may be called from monitor threads.
_seq_lock = _tsan.lock("health._seq_lock")
_seq_track: Dict[tuple, tuple] = {}


def _reset_seq_cache():
    """Forget all sequence-progress history (tests)."""
    with _seq_lock:
        if _tsan.TSAN:
            _tsan.note_write("health._seq_track")
        _seq_track.clear()


def _evidence_age(key, rank, wall, seq, now_wall, now_mono):
    """Age in seconds of the freshest liveness evidence for one
    transport's stamp.  Sequence progress is PREFERRED once history
    exists: the age is measured on the scanner's own monotonic clock
    from the moment the sequence value was first observed, so the
    stamped host's wall clock cannot skew the verdict in either
    direction.  Without seq history (first observation, pre-seq stamp)
    the wall-clock age rules."""
    seq_age = None
    if seq is not None:
        wall_age = max(0.0, now_wall - wall) if wall is not None else 0.0
        with _seq_lock:
            if _tsan.TSAN:
                _tsan.note_write("health._seq_track")
            prev = _seq_track.get((key, rank))
            if prev is None or prev[0] != seq:
                # advanced since the previous scan: fresh — but only
                # when there IS a previous scan; a first-ever
                # observation of a possibly-stale stamp must not read
                # as progress (its wall age is the baseline instead)
                _seq_track[(key, rank)] = (
                    seq, now_mono, 0.0 if prev is not None else wall_age)
                seq_age = 0.0 if prev is not None else None
            else:
                # unchanged: age accrues on OUR clock from the first
                # sighting, on top of how old the stamp already looked
                # then — without the baseline, discovering an ancient
                # stamp would read as "fresh" for one whole timeout
                seq_age = prev[2] + (now_mono - prev[1])
    if seq_age is not None:
        return seq_age
    if wall is None:
        return None
    return max(0.0, now_wall - wall)


def rank_evidence(num_workers: int, directory: Optional[str] = None,
                  role: str = "") -> Dict[int, Optional[float]]:
    """Freshest liveness-evidence age per rank in seconds (``None`` = no
    evidence on any transport — the rank has never stamped).  Scans both
    transports and takes the minimum age; returns an empty dict when no
    transport is in active use (matching :func:`dead_nodes`'s
    no-configuration behavior).  ``role`` scopes the scan to one stamp
    population (training = the empty role, ``"serve"`` = fleet
    replicas): a role's scan never reads — and never blames — another
    role's ranks, so both can share one coordination directory."""
    directory = directory or heartbeat_dir()
    client = _kv_client()
    kv = _kv_stamps(client, num_workers, role) if client is not None else {}
    kv_active = bool(kv)
    dir_active = bool(directory) and os.path.isdir(directory)
    files = _file_stamps(directory, num_workers, role) \
        if dir_active else {}
    if not kv_active and not dir_active:
        return {}
    now_wall, now_mono = time.time(), time.monotonic()
    out: Dict[int, Optional[float]] = {}
    for rank in range(num_workers):
        ages = []
        # the seq-progress memory is keyed by (transport, role, rank):
        # without the role, training rank 0 and serve replica 0 in one
        # directory would share one history slot and cross-blame
        for key, stamps in ((("kv", role), kv),
                            ((directory, role), files)):
            if rank not in stamps:
                continue
            wall, seq = stamps[rank]
            age = _evidence_age(key, rank, wall, seq, now_wall, now_mono)
            if age is not None:
                ages.append(age)
        out[rank] = min(ages) if ages else None
    return out


def dead_nodes(num_workers: int, timeout: float = 60.0,
               directory: Optional[str] = None,
               role: str = "") -> List[int]:
    """Ranks with no fresh liveness evidence on any transport within
    ``timeout`` seconds (the ``get_num_dead_node`` scan).  Empty when no
    transport is configured — matching the reference's single-process
    behavior: never declare a whole job dead on absence of
    configuration.  ``role`` scopes the scan (see
    :func:`rank_evidence`)."""
    evidence = rank_evidence(num_workers, directory=directory, role=role)
    if not evidence:
        return []
    return [rank for rank in range(num_workers)
            if evidence.get(rank) is None or evidence[rank] > timeout]
