"""Elastic data-parallel membership (``mxnet_tpu/elastic.py``):
dead-rank detection, shrink, relaunch of the survivors and resume.

The job carries a **membership epoch**, an integer and the list of live
ranks, on top of the ``health.py`` heartbeats; a dead rank triggers a
deterministic shrink-and-resume instead of a hung collective:

1. every rank stamps liveness (``health.Heartbeat``) and, before each
   step, a **step-barrier** stamp saying "I commit to step N";
2. the lowest surviving rank detects lapsed ranks
   (``health.rank_evidence``) and publishes epoch ``k+1`` with the
   shrunk world to the shared membership record (fsync'd tmp and
   rename, the checkpoint manifests' recipe);
3. every survivor observes the new epoch at its next batch boundary
   (:class:`ElasticShrink`), leaves its step loop and exits with
   :data:`SHRINK_EXIT_CODE`; ``tools/launch.py --local-elastic``
   relaunches the survivors, which join a smaller ``torch.distributed``
   group and resume from the newest intact checkpoint (the fused
   trainer's states blob holds whole leaves, so a ZeRO-1 run of two
   ranks restores onto one);
4. a rank declared dead while it is alive (a stalled heartbeat) sees
   that the epoch moved on without it (:class:`ElasticRevoked`) and
   exits without touching the checkpoint line.

The barrier comes before any collective of the step: a NCCL or gloo
collective with a dead peer hangs, and no rank enters the step until
every member has committed to it, so the bounded wait turns into
detection instead.  A rank dying inside a collective is still
fail-stop.

The record's format, the stamp files and the environment variables
(``MXTPU_ELASTIC_*``, set by ``tools/launch.py``) are the JAX
package's, so a membership record written by one package is read by
the other.  The comm-plan parity check is here as in the JAX package,
but the port traces no comm plan yet (ROADMAP item 10): ``fit``
publishes :data:`COMM_PLAN_UNTRACED`, and the peers log the check as
unverified.

Wiring: ``Module.fit(..., elastic=ElasticCoordinator())`` guards every
batch.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import List, Optional

from .base import MXNetError
from . import _tsan
from . import faults as _faults
from . import health as _health
from . import obs as _obs
from .parallel.collectives import _process_count, _process_index
from .resilience import retry_io

__all__ = ["ElasticCoordinator", "ElasticShrink", "ElasticRevoked",
           "Membership", "read_membership", "membership_path",
           "comm_plan_path", "SHRINK_EXIT_CODE"]

# a worker that exits because the membership shrank (not because IT
# failed) uses this code so the launcher can tell "relaunch the
# survivors" from "the job is broken"
SHRINK_EXIT_CODE = 96

_MEMBERSHIP_FILE = "membership.json"

# sentinel digest a rank publishes when its comm plan could not be
# traced: peers downgrade parity for that rank to a logged warning
# instead of dying on a missing stamp (a lint-trace hiccup on one rank
# must not kill the healthy fleet)
COMM_PLAN_UNTRACED = "untraced"

# measurement tolerance when deciding whether a heartbeat stamp
# predates this coordinator's start (previous incarnation) or was
# written during it (a real lapse)
_INCARNATION_SLACK_S = 1.0


def membership_path(directory: str, role: str = "") -> str:
    """The membership record for ``role``.  The empty role keeps the
    historical ``membership.json`` (the training world); a named role
    (``role="serve"`` — the serving fleet's replica membership) gets
    its own ``membership-<role>.json``, so a fleet and a co-resident
    training job can publish epochs in one coordination directory
    without clobbering each other's records (the health.py stamp-file
    role prefixes are the same contract one layer down)."""
    if role:
        return os.path.join(directory, "membership-%s.json" % role)
    return os.path.join(directory, _MEMBERSHIP_FILE)


def comm_plan_path(directory: str, rank: int) -> str:
    """Rank ``rank``'s published comm-plan record (digest + ordered
    collective keys) — the cross-rank plan parity token
    (the JAX package's comm-plan parity token)."""
    return os.path.join(directory, "commplan-%d" % int(rank))


def plan_digest(plan) -> str:
    """Stable digest of an ordered comm plan (the JAX package's
    ``analysis.comm_passes.plan_digest``): sha1 over each entry's key,
    one line each."""
    h = hashlib.sha1()
    for e in plan:
        h.update((e if isinstance(e, str) else e.key()).encode())
        h.update(b"\n")
    return h.hexdigest()


class Membership:
    """One membership epoch: the integer epoch, the live ranks, and the
    publish wallclock (the ``detect`` end of ``elastic_recovery_s``)."""

    __slots__ = ("epoch", "world", "num_workers", "wallclock", "dead")

    def __init__(self, epoch: int, world: List[int], num_workers: int,
                 wallclock: Optional[float] = None,
                 dead: Optional[List[int]] = None):
        self.epoch = int(epoch)
        self.world = sorted(int(r) for r in world)
        self.num_workers = int(num_workers)
        self.wallclock = wallclock
        self.dead = sorted(int(r) for r in (dead or ()))

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "world": self.world,
                "num_workers": self.num_workers,
                "wallclock": self.wallclock, "dead": self.dead}

    def __repr__(self):
        return "Membership(epoch=%d, world=%s)" % (self.epoch, self.world)


def read_membership(directory: str, num_workers: int,
                    role: str = "") -> Membership:
    """The current membership record; epoch 1 over all ranks when none
    has been published (the implicit founding epoch)."""
    if _tsan.TSAN:
        _tsan.note_read(
            "elastic.membership_record", lockfree=True,
            reason="atomic tmp+rename commit; readers see a whole "
                   "record or the previous one, never a torn write")
    try:
        with open(membership_path(directory, role)) as f:
            raw = json.load(f)
        return Membership(raw["epoch"], raw["world"],
                          raw.get("num_workers", num_workers),
                          raw.get("wallclock"), raw.get("dead"))
    except (OSError, ValueError, KeyError):
        # the record is only ever committed via atomic rename, so
        # "unreadable" means "never published", not "torn"
        return Membership(1, list(range(num_workers)), num_workers)


def _write_membership(directory: str, mem: Membership,
                      role: str = "") -> None:
    """Atomic, fsync'd commit of the membership record — the same
    tmp+rename recipe as the checkpoint manifests (``model._commit_file``
    is not reused verbatim: a fixed ``.tmp`` name would let two racing
    publishers tear each other; the pid-suffixed tmp cannot)."""
    if _tsan.TSAN:
        _tsan.note_write(
            "elastic.membership_record", lockfree=True,
            reason="atomic tmp+rename commit; readers see a whole "
                   "record or the previous one, never a torn write")
    path = membership_path(directory, role)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(mem.to_dict(), f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ElasticShrink(Exception):
    """The membership epoch moved: exit the step loop at this batch
    boundary, tear down, and let the orchestrator relaunch the shrunk
    world (which auto-resumes from the newest intact checkpoint).
    Deliberately NOT an MXNetError: generic training-error recovery
    must not swallow a membership transition."""

    def __init__(self, membership: Membership, dead=()):
        self.membership = membership
        self.dead = sorted(dead)
        # registry-backed event count:
        # one obs.snapshot() answers "how many shrinks has this
        # process observed" without grepping logs.  A revocation counts
        # ONLY under elastic.revocations (its subclass ctor) — this
        # rank was removed, it did not observe a surviving-world shrink
        if not isinstance(self, ElasticRevoked):
            _obs.counter("elastic.shrinks").inc()
        super().__init__(
            "membership epoch %d: world=%s dead=%s — exit and resume "
            "under the new world" % (membership.epoch, membership.world,
                                     self.dead))


class ElasticRevoked(ElasticShrink):
    """THIS rank was declared dead and shrunk out (lapsed heartbeat —
    possibly a stalled stamper on a live process, the split brain).  It
    must exit cleanly without touching the checkpoint line: the
    surviving world has already moved on."""

    def __init__(self, membership: Membership, dead=()):
        _obs.counter("elastic.revocations").inc()
        super().__init__(membership, dead=dead)


class ElasticCoordinator:
    """Per-rank membership agent: stamps liveness, guards every step
    entry, detects lapsed peers, publishes/observes membership epochs.

    ``guard()`` is the one call sites need — once per step, BEFORE the
    step's collectives::

        coord = ElasticCoordinator()
        try:
            mod.fit(train, elastic=coord, checkpoint=prefix, resume=True,
                    ...)
        except elastic.ElasticShrink:
            sys.exit(elastic.SHRINK_EXIT_CODE)   # orchestrator relaunches

    Deterministic monitor: the LOWEST surviving rank publishes the new
    epoch; everyone else only reads.  A lapsed rank is removed exactly
    once per epoch — the scan intersects with the CURRENT world, so a
    still-stale stamp of an already-removed rank can never double-
    shrink, and a slow rejoiner finds itself revoked instead of racing
    the survivors.

    Env defaults (each also a constructor argument):

    * ``MXTPU_ELASTIC_DIR`` — shared membership/barrier directory
      (defaults to ``MXTPU_HEARTBEAT_DIR``).
    * ``MXTPU_ELASTIC_HB_TIMEOUT_S`` (10) — heartbeat staleness that
      declares a rank dead.
    * ``MXTPU_ELASTIC_STEP_TIMEOUT_S`` (60) — bounded pre-step barrier
      wait for the first attempt; each retry doubles it (the retry_io
      backoff shape: worst case ``(2**attempts - 1) * step_timeout``
      before the wedged error).
    * ``MXTPU_ELASTIC_CHECK_S`` (2) — throttle on the monitor scan.
    * ``MXTPU_ELASTIC_JOIN_GRACE_S`` (120) — never declare a rank that
      has NOT YET stamped dead before this much time has passed since
      this coordinator started (ranks compile/initialize at different
      speeds; a rank that HAS stamped and lapsed is dead regardless).
    """

    def __init__(self, rank: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 directory: Optional[str] = None,
                 heartbeat: Optional["_health.Heartbeat"] = None,
                 hb_timeout: Optional[float] = None,
                 step_timeout: Optional[float] = None,
                 check_interval: Optional[float] = None,
                 join_grace: Optional[float] = None,
                 barrier_attempts: int = 3,
                 poll_interval: float = 0.02,
                 logger=None):
        def _envf(value, env, default):
            if value is not None:
                return float(value)
            return float(os.environ.get(env, "") or default)

        if rank is None:
            rank = int(os.environ.get("MXTPU_PROCESS_ID", "") or
                       _process_index())
        if num_workers is None:
            num_workers = int(os.environ.get("MXTPU_NUM_PROCESSES", "") or
                              _process_count())
        self.rank = int(rank)
        self.num_workers = int(num_workers)
        self.directory = directory or os.environ.get("MXTPU_ELASTIC_DIR") \
            or _health.heartbeat_dir()
        if not self.directory:
            raise MXNetError(
                "ElasticCoordinator needs a shared directory: pass "
                "directory= or set MXTPU_ELASTIC_DIR / "
                "MXTPU_HEARTBEAT_DIR (tools/launch.py --local-elastic "
                "sets both)")
        os.makedirs(self.directory, exist_ok=True)
        self.hb_timeout = _envf(hb_timeout, "MXTPU_ELASTIC_HB_TIMEOUT_S",
                                10.0)
        self.step_timeout = _envf(step_timeout,
                                  "MXTPU_ELASTIC_STEP_TIMEOUT_S", 60.0)
        self.check_interval = _envf(check_interval, "MXTPU_ELASTIC_CHECK_S",
                                    2.0)
        self.join_grace = _envf(join_grace, "MXTPU_ELASTIC_JOIN_GRACE_S",
                                120.0)
        self.barrier_attempts = max(1, int(barrier_attempts))
        self.poll_interval = float(poll_interval)
        self.logger = logger or logging.getLogger("mxtpu.elastic")
        self._own_hb = heartbeat is None
        self._hb = heartbeat if heartbeat is not None else _health.Heartbeat(
            self.rank, directory=self.directory,
            interval=min(_health._DEFAULT_INTERVAL, self.hb_timeout / 4.0))
        self._start_mono = time.monotonic()
        self._last_scan = 0.0
        self._guards = 0
        self._mem_cache = None
        # cross-rank comm-plan parity: armed by publish_comm_plan, checked
        # once at the first guarded step entry
        self._comm_digest = None
        self._comm_keys = None
        self._comm_checked = False
        self.comm_parity_timeout = float(
            os.environ.get("MXTPU_COMM_PARITY_TIMEOUT_S", "")
            or self.step_timeout)
        # new-incarnation adoption: a record whose world SIZE differs
        # from ours is a previous incarnation's (a supervisor relaunched
        # the shrunk world into the same shared dir with new contiguous
        # ranks) — membership() synthesizes the founding epoch over the
        # env world instead of instantly revoking renumbered ranks;
        # rank 0 persists it so external readers converge
        disk = read_membership(self.directory, self.num_workers)
        if disk.num_workers != self.num_workers and self.rank == 0:
            founding = self.membership()
            founding.wallclock = time.time()
            retry_io(lambda: _write_membership(self.directory, founding),
                     what="membership founding write", logger=self.logger)
        self._epoch = self.membership().epoch

    # ------------------------------------------------------------ state
    def membership(self) -> Membership:
        mem = read_membership(self.directory, self.num_workers)
        if mem.num_workers != self.num_workers:
            # previous incarnation's record (see __init__): every rank
            # of the new incarnation deterministically computes the
            # same founding epoch from it
            mem = Membership(mem.epoch + 1, list(range(self.num_workers)),
                             self.num_workers)
        return mem

    def _barrier_path(self, rank: int) -> str:
        return os.path.join(self.directory, "step-%d" % rank)

    def _stamp_step(self, step: int) -> None:
        # "<epoch> <step>": epoch-scoped so a stale stamp from a
        # previous incarnation sharing this directory can never satisfy
        # (and silently disarm) the new incarnation's barrier
        tmp = "%s.tmp" % self._barrier_path(self.rank)
        with open(tmp, "w") as f:
            f.write("%d %d\n" % (self._epoch, step))
        os.replace(tmp, self._barrier_path(self.rank))

    def _read_step(self, rank: int) -> int:
        try:
            with open(self._barrier_path(rank)) as f:
                epoch, step = f.read().split()[:2]
            return int(step) if int(epoch) == self._epoch else -1
        except (OSError, ValueError, IndexError):
            return -1

    # ------------------------------------------------- comm-plan parity
    def publish_comm_plan(self, plan, digest: Optional[str] = None) -> str:
        """Stamp this rank's comm-plan digest into the shared dir —
        call BEFORE the first guarded step (``Module.fit`` does, from
        ``Trainer.comm_plan()``).  ``plan`` is the ordered entry list
        (entries with a ``key()``, or those key strings); the first
        :meth:`guard` then refuses to enter the step collectives until
        every member's digest matches — a rank-divergent program
        becomes a loud pre-step ``MXNetError`` naming the diverging rank
        and the first differing collective, instead of a silent wedge
        inside a collective.  The port traces no plan yet (ROADMAP item
        10): ``fit`` publishes :data:`COMM_PLAN_UNTRACED`."""
        keys = [e if isinstance(e, str) else e.key() for e in plan]
        if digest is None:
            digest = plan_digest(keys)
        record = {"rank": self.rank, "epoch": self._epoch,
                  "digest": digest, "plan": keys,
                  "wallclock": time.time()}
        path = comm_plan_path(self.directory, self.rank)
        tmp = "%s.tmp.%d" % (path, os.getpid())

        def write():
            with open(tmp, "w") as f:
                json.dump(record, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        retry_io(write, what="comm plan publish", logger=self.logger)
        self._comm_digest = digest
        self._comm_keys = keys
        self._comm_checked = False
        return digest

    def _read_comm_plan(self, rank: int) -> Optional[dict]:
        try:
            with open(comm_plan_path(self.directory, rank)) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return None
        # epoch-scoped like the barrier stamps: a previous
        # incarnation's plan file must not satisfy this epoch's check.
        # Known limitation, shared with the step barrier's stamps: a
        # same-size restart into the same shared dir keeps the epoch,
        # so a crashed run's plan file can satisfy the new run's check
        # until the peer republishes (the elastic launcher's relaunch
        # path bumps the epoch; a divergent peer still fails ITS OWN
        # parity check and the survivor degrades to heartbeat-detected
        # shrink, never a permanent wedge).
        if int(raw.get("epoch", -1)) != self._epoch:
            return None
        return raw

    def _check_comm_parity(self, mem: Membership) -> None:
        """Bounded-wait for every member's plan record, then require
        digest agreement.  Runs once, at the first guarded step."""
        self._comm_checked = True
        peers = [r for r in mem.world if r != self.rank]
        deadline = time.monotonic() + self.comm_parity_timeout
        records = {}
        while True:
            for r in peers:
                if r not in records:
                    rec = self._read_comm_plan(r)
                    if rec is not None:
                        records[r] = rec
            if len(records) == len(peers):
                break
            if time.monotonic() >= deadline:
                missing = sorted(set(peers) - set(records))
                raise MXNetError(
                    "comm-plan parity: rank(s) %s published no comm "
                    "plan for epoch %d within %.1fs — refusing to "
                    "enter the step collectives unverified (disable "
                    "with MXTPU_COMM_PARITY=0)"
                    % (missing, self._epoch, self.comm_parity_timeout))
            time.sleep(max(self.poll_interval, 0.02))
        unverified = False
        for r in sorted(records):
            rec = records[r]
            if COMM_PLAN_UNTRACED in (rec["digest"], self._comm_digest):
                # a side traced no plan (the port's fit publishes the
                # sentinel until it traces comm plans): parity for this
                # pair is unverifiable — warn, don't kill a healthy fleet
                self.logger.warning(
                    "rank %d: comm-plan parity with rank %d is "
                    "UNVERIFIED (digest %r vs %r) — one side could not "
                    "trace its plan", self.rank, r,
                    self._comm_digest, rec["digest"])
                unverified = True
                continue
            if rec["digest"] == self._comm_digest:
                continue
            mine, theirs = self._comm_keys or [], rec.get("plan") or []
            idx = next((i for i, (a, b) in enumerate(zip(mine, theirs))
                        if a != b), min(len(mine), len(theirs)))
            local = mine[idx] if idx < len(mine) else "<absent>"
            peer = theirs[idx] if idx < len(theirs) else "<absent>"
            raise MXNetError(
                "comm-plan parity check FAILED before step entry: rank "
                "%d's plan digest %.12s != rank %d's %.12s — the ranks "
                "would issue DIVERGENT collectives and wedge inside "
                "them.  First differing collective at plan index %d: "
                "rank %d has %s, rank %d has %s (%d vs %d entries "
                "total).  Fix the rank-conditioned program divergence."
                % (self.rank, self._comm_digest, r, rec["digest"], idx,
                   self.rank, local, r, peer, len(mine), len(theirs)))
        if unverified:
            return
        self.logger.info(
            "rank %d: comm-plan parity OK across world %s (digest "
            "%.12s, %d collectives)", self.rank, mem.world,
            self._comm_digest, len(self._comm_keys or []))

    # ------------------------------------------------------------ guard
    def guard(self, step: Optional[int] = None) -> Membership:
        """The collective-entry guard: call once per step, before the
        step's collectives run.  Stamps "this rank commits to ``step``",
        verifies the membership epoch, runs the (throttled) monitor
        scan, and waits — bounded — until every member has committed to
        the same step.  Raises :class:`ElasticShrink` (the world
        shrank: exit and resume) or :class:`ElasticRevoked` (YOU were
        shrunk out: exit, touch nothing)."""
        self._guards += 1
        step = self._guards if step is None else int(step)
        if _faults.hit("host_dead", step=step, rank=self.rank):
            # the injected whole-host death: SIGKILL-faithful, and
            # BEFORE the barrier stamp — peers must never believe this
            # rank committed to the step
            os._exit(137)
        # the fit-loop "elastic guard" phase on the span timeline:
        # nests under fit's train.step root when called from there
        with _obs.span("elastic.guard",
                       attrs={"step": step} if _obs.OBS else None):
            now = time.monotonic()
            if self._mem_cache is None \
                    or now - self._last_scan >= self.check_interval:
                # membership read and liveness scan share the throttle:
                # on fast steps an unconditional per-step json read of
                # the shared record would be the same metadata storm
                # the barrier loop avoids; epoch observation lag stays
                # bounded by one scan period
                self._last_scan = now
                self._mem_cache = self._check_membership()
                self._scan(self._mem_cache)
            mem = self._mem_cache
            if self._comm_digest is not None and not self._comm_checked \
                    and len(mem.world) > 1:
                # plan parity BEFORE the first barrier commit: a
                # divergent rank must fail loudly while every member is
                # still outside the step collectives
                self._check_comm_parity(mem)
            if len(mem.world) > 1:
                self._barrier(step, mem)
            return mem

    def _check_membership(self) -> Membership:
        mem = self.membership()
        if self.rank not in mem.world:
            self.logger.warning(
                "rank %d: revoked by membership epoch %d (world=%s) — "
                "exiting without touching the checkpoint line",
                self.rank, mem.epoch, mem.world)
            raise ElasticRevoked(mem, dead=[self.rank])
        if mem.epoch != self._epoch:
            raise ElasticShrink(mem, dead=mem.dead)
        return mem

    # ---------------------------------------------------------- monitor
    def _lapsed(self, mem: Membership) -> List[int]:
        """Members (other than self) whose liveness has lapsed.  A rank
        that has never stamped is only "dead" once ``join_grace`` has
        passed — slow starters are not failures; a rank that HAS
        stamped and went stale is dead on ``hb_timeout`` alone (the
        sequence-progress scan in health.py makes that judgment
        clock-skew tolerant)."""
        evidence = _health.rank_evidence(self.num_workers,
                                         directory=self.directory)
        if not evidence:
            return []
        elapsed = time.monotonic() - self._start_mono
        grace_left = elapsed < self.join_grace
        out = []
        for rank in mem.world:
            if rank == self.rank:
                continue
            age = evidence.get(rank)
            if age is not None and age <= self.hb_timeout:
                continue                       # fresh
            if grace_left and (age is None
                               or age > elapsed + _INCARNATION_SLACK_S):
                # no stamp from THIS incarnation yet: either the rank
                # has never stamped, or the only evidence predates this
                # coordinator's start (a previous incarnation's stale
                # file in a shared dir) — a slow starter, not a lapse.
                # The slack is small measurement tolerance, NOT
                # hb_timeout: a stamp merely hb_timeout older than our
                # start is still a pre-incarnation stamp, and counting
                # it would spuriously shrink a slow starter.
                continue
            out.append(rank)
        return out

    def _scan(self, mem: Membership) -> None:
        """One monitor pass: on lapsed members, the lowest surviving
        rank publishes the shrunk epoch and raises
        :class:`ElasticShrink`; every OTHER survivor keeps its
        heartbeat visible and waits (bounded) to observe the published
        epoch — exiting on a locally computed, never-published
        membership would stop this rank's stamps before a busy
        publisher (mid checkpoint write) runs its own scan, which
        would then find this healthy rank lapsed too and over-shrink
        the job."""
        lapsed = self._lapsed(mem)
        if not lapsed:
            return
        survivors = [r for r in mem.world if r not in lapsed]
        if self.rank == min(survivors):
            new = Membership(mem.epoch + 1, survivors, self.num_workers,
                             wallclock=time.time(), dead=lapsed)
            self._publish(mem, new)
            raise ElasticShrink(new, dead=lapsed)
        deadline = time.monotonic() + self.step_timeout
        while time.monotonic() < deadline:
            now = time.monotonic()
            if now - self._last_scan >= self.check_interval:
                # same throttle as the barrier loop: the wait must not
                # itself become a membership/heartbeat metadata storm
                self._last_scan = now
                self._check_membership()   # raises once the epoch moves
                lapsed = self._lapsed(mem)
                if not lapsed:
                    return                 # a flap resolved: no shrink
                survivors = [r for r in mem.world if r not in lapsed]
                if self.rank == min(survivors):
                    # the expected publisher lapsed too: the duty falls
                    # to this rank
                    new = Membership(mem.epoch + 1, survivors,
                                     self.num_workers,
                                     wallclock=time.time(), dead=lapsed)
                    self._publish(mem, new)
                    raise ElasticShrink(new, dead=lapsed)
            time.sleep(max(self.poll_interval, 0.05))
        # publisher alive but silent through the whole bounded wait:
        # exiting on the predicted membership beats wedging the job
        raise ElasticShrink(
            Membership(mem.epoch + 1, survivors, self.num_workers,
                       wallclock=time.time(), dead=lapsed), dead=lapsed)

    def _publish(self, prev: Membership, new: Membership) -> None:
        def write():
            cur = read_membership(self.directory, self.num_workers)
            if cur.epoch > prev.epoch:
                return      # a racing publisher already moved the epoch
            _write_membership(self.directory, new)
        retry_io(write, what="membership publish", logger=self.logger)
        self.logger.warning(
            "rank %d: published membership epoch %d — dead=%s, "
            "surviving world=%s", self.rank, new.epoch, new.dead,
            new.world)

    # ---------------------------------------------------------- barrier
    def _barrier(self, step: int, mem: Membership) -> None:
        """Commit to ``step`` and wait (bounded) for every member's
        commitment.  While waiting: watch the membership epoch (another
        survivor may publish first) and run the throttled liveness scan
        (a peer dying DURING the wait is detected in ~hb_timeout, not
        step_timeout).  A timeout with every peer still heartbeat-fresh
        is retried with backoff — ``barrier_attempts`` waits starting
        at ``step_timeout`` and doubling, the retry_io shape — before
        declaring the job wedged."""
        self._stamp_step(step)
        peers = [r for r in mem.world if r != self.rank]
        for attempt in range(self.barrier_attempts):
            deadline = time.monotonic() + self.step_timeout * (2 ** attempt)
            while time.monotonic() < deadline:
                waiting = [r for r in peers if self._read_step(r) < step]
                if not waiting:
                    return
                now = time.monotonic()
                if now - self._last_scan >= self.check_interval:
                    # membership re-read and liveness scan share the
                    # throttle: the tight loop below polls only the
                    # peer step files, not the shared membership record
                    # (50 json reads/s per rank on an NFS dir is a
                    # metadata storm for no detection benefit)
                    self._last_scan = now
                    self._check_membership()
                    self._scan(mem)
                time.sleep(self.poll_interval)
            # bounded wait expired: one unthrottled scan before retrying
            self._scan(mem)
            self.logger.warning(
                "rank %d: step-%d barrier timed out (attempt %d/%d) but "
                "every peer's heartbeat is fresh — backing off and "
                "retrying", self.rank, step, attempt + 1,
                self.barrier_attempts)
        raise MXNetError(
            "elastic step barrier wedged: ranks %s never committed to "
            "step %d across %d bounded waits and their heartbeats are "
            "fresh" % ([r for r in peers if self._read_step(r) < step],
                       step, self.barrier_attempts))

    # ------------------------------------------------------- quarantine
    def quarantine(self, rank: int, attempts: int = 3) -> Membership:
        """Shrink ``rank`` out of the membership by POLICY rather than
        by lapsed heartbeat — the integrity vote's outvoted replica
        (``integrity.py``).  Publishes
        the next epoch without it through the same atomic commit as the
        dead-host path, so every survivor observes ``ElasticShrink`` at
        its next guard and the quarantined rank — which is alive and
        heartbeating, that is the point — observes ``ElasticRevoked``
        and exits without touching the checkpoint line.  Idempotent:
        an already-absent rank publishes nothing.

        Race-safe: ``_publish`` yields to a concurrent publisher that
        already moved the epoch (e.g. the monitor shrinking a genuinely
        dead peer) — unlike that path, where racing writers carry
        identical content, losing THIS write would silently keep the
        flaky rank in the world.  So the publish is re-read and retried
        against the fresh record until the rank is gone."""
        rank = int(rank)
        for _ in range(max(1, int(attempts))):
            mem = self.membership()
            if rank not in mem.world:
                return mem
            # fold concurrently-LAPSED peers into this publish: two
            # same-epoch writers clobber each other (atomic rename,
            # last write wins), and unlike the dead-host path — where
            # racing writers carry identical content — the monitor's
            # shrink and this quarantine differ.  Removing the union
            # makes either winner correct: if this write lands last it
            # does not resurrect a dead peer the monitor just removed,
            # and if the monitor's lands last the retry below re-reads
            # and quarantines on top of it.
            lapsed = [r for r in self._lapsed(mem) if r != rank]
            survivors = [r for r in mem.world
                         if r != rank and r not in lapsed]
            if not survivors:
                raise MXNetError(
                    "refusing to quarantine rank %d: it is the only "
                    "member left (epoch %d)" % (rank, mem.epoch))
            new = Membership(mem.epoch + 1, survivors, self.num_workers,
                             wallclock=time.time(),
                             dead=sorted([rank] + lapsed))
            self._publish(mem, new)
            cur = self.membership()
            if rank not in cur.world:
                _obs.counter("elastic.quarantines").inc()
                self.logger.warning(
                    "rank %d: QUARANTINED rank %d (integrity outvote) — "
                    "membership epoch %d, surviving world %s", self.rank,
                    rank, cur.epoch, cur.world)
                return cur
        raise MXNetError(
            "quarantine of rank %d kept losing the membership publish "
            "race after %d attempts (epoch now %d, world %s)"
            % (rank, attempts, cur.epoch, cur.world))

    def close(self) -> None:
        if self._own_hb:
            self._hb.stop()
