"""Filesystem work queue with atomic lease files (a copy of
``sagecal_tpu/fleet/queue.py``, stdlib only).

The queue is a directory three kinds of file live in, one per request:

- ``item-<rid>.json`` — the work item (the request dict plus scheduling
  metadata: absolute ``deadline``, ``bucket_hint``, ``enqueued_at``).
  Written once by the coordinator, never mutated.
- ``lease-<rid>.e<K>.json`` — the lease *epoch chain*.  Epoch files are
  **published atomically** (staged to a tmp name, then hard-linked into
  place: the name appears with its full content in one step, and
  ``link`` fails with ``EEXIST`` if someone else won) and **never
  rewritten**: every state change of the lease (claim, renew, steal,
  release) is the publication of the next epoch file, and the head of
  the chain (highest ``K``) is the current lease.  Exclusive publish on
  a never-reused name is the linearization point — of N workers racing
  to advance the chain, exactly one creates ``e<K+1>`` and the rest
  observe it and back off.  A plain ``O_CREAT|O_EXCL`` create followed
  by a separate content write would NOT do: the head is visible but
  empty between the two ops, and a peer that reads the torn head while
  its creator is alive mid-write would treat the lease as dead and
  advance over it (the model checker demonstrates that double claim —
  see the ``torn-publish`` mutation).
- ``done-<rid>.json`` — the completion marker, written atomically
  AFTER the result manifest is on disk.  Claims check it first and
  last, so a request completed between the expiry check and the new
  epoch is released untouched.

Why an epoch chain instead of delete + recreate: a steal that unlinks
(or renames away) the dead lease file and then re-creates it has an
ABA window — a second stealer that read the same dead lease can rename
or unlink the *winner's freshly created live lease* (rename/unlink act
on a name, not on the content the stealer validated), yielding two
workers that both believe they hold the claim.  The protocol model
checker (the reference's ``analysis/protocol_check.py``) finds that
interleaving mechanically.  With the chain, nothing is ever deleted or
rewritten while a request is in flight, so the content a stealer
validated ("head epoch K is expired") is immutable, and two further
properties make observed expiry *stable*:

- :meth:`renew` refuses an already-expired head (``LeaseLost``), so an
  expired epoch can never be resurrected by its old holder;
- an unparsable head (external corruption, or garbage left by an older
  protocol) is treated as expired, so nothing can wedge a request
  un-claimably — and because epoch files are immutable once published,
  "this head is dead" is a stable observation, never a torn-write
  transient.

Exactly-once *effects* come from the result-manifest layer, not the
queue: a zombie worker whose lease was stolen may finish its solve in
parallel with the stealer, but both write the same deterministic
result (per-request RNG is derived from the request id and vmapped
lanes are independent) through atomic ``os.replace``, so the manifest
set contains no duplicates and no torn files.  :meth:`complete` sweeps
the (inert) epoch files after the done marker lands.

Claim ordering is deadline-first (EDF) with bucket affinity: a worker
prefers items whose ``bucket_hint`` it has already compiled/claimed —
that is what lets same-shape requests land on the same worker and fill
its vmapped batch lanes — but never at the cost of an earlier deadline
in a different bucket beyond the batch window.

Everything here is stdlib-only and safe on any POSIX filesystem with
atomic rename.  All filesystem access goes through an injectable
``fs`` object (:class:`RealFS` by default) and all time reads through
an injectable ``clock`` — the two seams the model checker uses to
drive this exact code through simulated interleavings, crashes, and
logical time (the reference's ``analysis/fsmodel.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

ITEM_PREFIX = "item-"
LEASE_PREFIX = "lease-"
DONE_PREFIX = "done-"
FAIL_PREFIX = "fail-"


class LeaseLost(RuntimeError):
    """Raised by :meth:`LeaseQueue.renew` when the caller's lease no
    longer exists, is held by another worker (it expired and was
    stolen), or has already expired (renewing it could resurrect a
    lease a stealer has validated as dead).  The holder must treat the
    request as no longer its own."""


class RealFS:
    """The production filesystem, at the op granularity the lease
    protocol relies on.  Each method is one crash-atomic step:

    - ``publish_excl`` — unique tmp + fsync + ``os.link`` into place:
      the name appears with its full content in one step, exactly one
      publisher wins (``EEXIST``), and a crash loses only invisible
      tmp state — never a visible torn file;
    - ``write_atomic`` — unique tmp + fsync + ``os.replace`` (readers
      see the old content or the new, never a torn file; a crash loses
      only un-renamed tmp state);
    - ``unlink_matching`` — one cleanup sweep over a name prefix;
    - ``open_excl`` / ``commit`` / ``create`` — the torn-window
      primitives, NOT used by the shipped protocol; they exist so the
      checker's seeded mutations can express the buggy variants.

    The simulator (the reference's ``analysis/fsmodel.py``) implements the same
    surface deterministically; the differential test in
    reference's tests/test_protocol.py pins that both behave identically on
    crash-free schedules.
    """

    _seq = itertools.count()

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def read_text(self, path: str) -> str:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()

    def open_excl(self, path: str) -> int:
        return os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)

    def create(self, path: str) -> int:
        """Plain truncating create — NOT used by the protocol (claims
        must win ``publish_excl``); present so the simulator and the
        real fs expose the same surface to the checker's mutations."""
        return os.open(path, os.O_CREAT | os.O_TRUNC | os.O_WRONLY)

    def publish_excl(self, path: str, text: str) -> None:
        """Atomically publish ``text`` at ``path``, failing with
        :class:`FileExistsError` if the name already exists.  The hard
        link makes the name appear with its full content in one step —
        a reader can never observe a half-written file, unlike
        ``open_excl`` + ``commit``."""
        tmp = f"{path}.tmp.{self.unique_suffix()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def commit(self, fd: int, text: str) -> None:
        try:
            os.write(fd, text.encode("utf-8"))
            os.fsync(fd)
        finally:
            os.close(fd)

    def write_atomic(self, path: str, text: str) -> None:
        tmp = f"{path}.tmp.{self.unique_suffix()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    def unlink_matching(self, dirpath: str, prefix: str) -> int:
        n = 0
        try:
            names = os.listdir(dirpath)
        except OSError:
            return 0
        for name in names:
            if name.startswith(prefix):
                try:
                    os.unlink(os.path.join(dirpath, name))
                    n += 1
                except OSError:
                    pass
        return n

    def unique_suffix(self) -> str:
        return f"{os.getpid()}.{next(self._seq)}.{uuid.uuid4().hex[:8]}"


_REAL_FS = RealFS()


@dataclasses.dataclass
class WorkItem:
    """One queued request plus its scheduling metadata."""

    request_id: str
    tenant: str
    request: Dict[str, Any]     # the SolveRequest fields, verbatim
    deadline: float = math.inf  # absolute unix deadline (EDF key)
    bucket_hint: str = ""       # shape-affinity key (coordinator-set)
    enqueued_at: float = 0.0
    large: bool = False         # place via sharded_joint_fit

    def to_doc(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if math.isinf(self.deadline):
            d["deadline"] = None
        return d

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "WorkItem":
        d = dict(doc)
        if d.get("deadline") is None:
            d["deadline"] = math.inf
        return cls(**{k: d[k] for k in
                      ("request_id", "tenant", "request", "deadline",
                       "bucket_hint", "enqueued_at", "large") if k in d})


def _dump_json(doc: Dict[str, Any]) -> str:
    return json.dumps(doc, sort_keys=True, default=float) + "\n"


def _parse_json(text: str) -> Optional[Dict[str, Any]]:
    try:
        doc = json.loads(text)
    except (ValueError, TypeError):
        return None
    return doc if isinstance(doc, dict) else None


class LeaseQueue:
    """One worker's (or the coordinator's) handle on a shared queue
    directory.  All methods are safe to call concurrently from any
    number of processes."""

    def __init__(self, root: str, worker: Optional[str] = None,
                 ttl_s: float = 30.0, fs=None, clock=None):
        from sagecal_tpu_torch.obs.aggregate import worker_id

        self.root = root
        self.worker = worker or worker_id()
        self.ttl_s = float(ttl_s)
        self.fs = fs if fs is not None else _REAL_FS
        self.clock = clock if clock is not None else time.time
        self.fs.makedirs(root)

    def _now(self, now: Optional[float]) -> float:
        return self.clock() if now is None else float(now)

    def _read_json(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            text = self.fs.read_text(path)
        except OSError:
            return None
        return _parse_json(text)

    # -- paths ---------------------------------------------------------

    def item_path(self, rid: str) -> str:
        return os.path.join(self.root, f"{ITEM_PREFIX}{rid}.json")

    def lease_path(self, rid: str, epoch: int = 0) -> str:
        return os.path.join(self.root,
                            f"{LEASE_PREFIX}{rid}.e{epoch:06d}.json")

    def done_path(self, rid: str) -> str:
        return os.path.join(self.root, f"{DONE_PREFIX}{rid}.json")

    # -- the lease chain ----------------------------------------------

    def _head_epoch(self, rid: str) -> int:
        """Highest existing epoch for ``rid``, or -1 for no lease."""
        prefix = f"{LEASE_PREFIX}{rid}.e"
        head = -1
        for name in self.fs.listdir(self.root):
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            try:
                head = max(head, int(name[len(prefix):-len(".json")]))
            except ValueError:
                continue
        return head

    def _lease_head(self, rid: str) -> Tuple[int,
                                             Optional[Dict[str, Any]]]:
        """(head epoch, parsed doc).  ``(-1, None)`` when no epoch file
        exists; ``(k, None)`` for an unparsable head (corruption or
        older-protocol garbage; the atomic publish never leaves one) —
        treated as expired, which is stable because epoch files are
        immutable."""
        epoch = self._head_epoch(rid)
        if epoch < 0:
            return -1, None
        return epoch, self._read_json(self.lease_path(rid, epoch))

    def _advance(self, rid: str, epoch: int,
                 doc: Dict[str, Any]) -> bool:
        """Try to publish epoch ``epoch+1`` with ``doc``.  True iff
        this worker won the publish (the only mutation point of the
        chain).  The publish is a single atomic step — the new head
        appears with its full content, so no peer can ever read it
        half-written and mistake a live lease for a dead one."""
        try:
            self.fs.publish_excl(self.lease_path(rid, epoch + 1),
                                 _dump_json(dict(doc, epoch=epoch + 1)))
        except (FileExistsError, OSError):
            return False
        return True

    @staticmethod
    def _live(doc: Optional[Dict[str, Any]], now: float) -> bool:
        return doc is not None \
            and float(doc.get("expires_at", 0.0)) > now

    # -- producer side -------------------------------------------------

    def put(self, item: WorkItem, now: Optional[float] = None) -> str:
        if not item.enqueued_at:
            item.enqueued_at = self._now(now)
        path = self.item_path(item.request_id)
        self.fs.write_atomic(path, _dump_json(item.to_doc()))
        return path

    # -- introspection -------------------------------------------------

    def items(self) -> List[WorkItem]:
        out: List[WorkItem] = []
        for name in self.fs.listdir(self.root):
            if not (name.startswith(ITEM_PREFIX)
                    and name.endswith(".json")):
                continue
            doc = self._read_json(os.path.join(self.root, name))
            if doc and doc.get("request_id"):
                out.append(WorkItem.from_doc(doc))
        return out

    def done_ids(self) -> Set[str]:
        n, s = len(DONE_PREFIX), len(".json")
        return {name[n:-s] for name in self.fs.listdir(self.root)
                if name.startswith(DONE_PREFIX)
                and name.endswith(".json")}

    def read_lease(self, rid: str) -> Optional[Dict[str, Any]]:
        return self._lease_head(rid)[1]

    def read_done(self, rid: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self.done_path(rid))

    def pending(self, now: Optional[float] = None) -> List[WorkItem]:
        """Items with no done marker and no LIVE lease, i.e. claimable
        right now (unleased, or leased-but-expired)."""
        now = self._now(now)
        done = self.done_ids()
        out: List[WorkItem] = []
        for it in self.items():
            if it.request_id in done:
                continue
            if self._live(self.read_lease(it.request_id), now):
                continue
            out.append(it)
        return out

    def stats(self, now: Optional[float] = None) -> Dict[str, int]:
        now = self._now(now)
        items = self.items()
        done = self.done_ids()
        leased = expired = 0
        for it in items:
            if it.request_id in done:
                continue
            epoch, doc = self._lease_head(it.request_id)
            if epoch < 0:
                continue
            if self._live(doc, now):
                leased += 1
            else:
                expired += 1
        ndone = sum(1 for i in items if i.request_id in done)
        return {"items": len(items), "done": ndone,
                "leased": leased, "expired_leases": expired,
                # never-leased items still waiting to be claimed (the
                # live-timeline waiting-room gauge)
                "waiting": max(len(items) - ndone - leased - expired,
                               0)}

    def all_done(self, empty: bool = True) -> bool:
        """True iff every queued request has a done marker.  ``empty``
        picks the answer for a queue with no items at all: a seeded
        fleet treats that as drained (vacuous truth), while open-loop
        load harnesses pass ``empty=False`` because arrivals are still
        being submitted and an empty queue just means "no work YET"."""
        items = self.items()
        if not items:
            return empty
        done = self.done_ids()
        return all(it.request_id in done for it in items)

    # -- claim protocol ------------------------------------------------

    def claim(self, rid: str, now: Optional[float] = None) -> bool:
        """Try to acquire the lease on one request.  True iff THIS
        worker now holds it.  Never blocks, never raises on contention.

        A vacant, expired, released, or unparsable head is claimable;
        the claim is winning the exclusive publish of the next epoch
        file.  The observed head can never become live again in
        between (expired heads are immutable and un-renewable), so
        winning the publish IS acquiring the lease — there is no
        recreate window for a second stealer to clobber."""
        now = self._now(now)
        if self.fs.exists(self.done_path(rid)):
            return False
        epoch, doc = self._lease_head(rid)
        if self._live(doc, now):
            return False
        won = self._advance(rid, epoch, {
            "worker": self.worker, "request_id": rid,
            "acquired_at": now, "renewed_at": now,
            "expires_at": now + self.ttl_s})
        if not won:
            return False
        if self.fs.exists(self.done_path(rid)):
            # completed between our expiry check and the create: the
            # work is finished, back out
            self.release(rid, now=now)
            return False
        return True

    def renew(self, rid: str, now: Optional[float] = None) -> float:
        """Extend this worker's lease by ``ttl_s``.  Returns the new
        expiry; raises :class:`LeaseLost` when the lease is gone, held
        by someone else (stolen after expiry), or already expired.

        Refusing an expired lease is load-bearing, not cosmetic: it is
        what makes "this head is expired" a STABLE observation, so a
        stealer that validated the head as dead can win the next epoch
        without racing a resurrection."""
        now = self._now(now)
        epoch, doc = self._lease_head(rid)
        if doc is None or doc.get("worker") != self.worker:
            raise LeaseLost(
                f"lease on {rid} lost (now held by "
                f"{(doc or {}).get('worker', 'nobody')!r})")
        if not self._live(doc, now):
            raise LeaseLost(
                f"lease on {rid} expired at "
                f"{float(doc.get('expires_at', 0.0)):.3f} "
                f"(now {now:.3f}); it may already be stolen")
        doc = dict(doc, renewed_at=now, expires_at=now + self.ttl_s)
        if not self._advance(rid, epoch, doc):
            raise LeaseLost(
                f"lease on {rid} lost (chain advanced past epoch "
                f"{epoch} underneath this worker)")
        return doc["expires_at"]

    def release(self, rid: str, now: Optional[float] = None) -> None:
        """Give the claim up (no-op unless this worker holds the live
        head): the next epoch records an immediately-expired lease, so
        any worker may claim without waiting out the TTL."""
        now = self._now(now)
        epoch, doc = self._lease_head(rid)
        if doc is None or doc.get("worker") != self.worker \
                or not self._live(doc, now):
            return
        self._advance(rid, epoch, {
            "worker": self.worker, "request_id": rid,
            "acquired_at": doc.get("acquired_at", now),
            "renewed_at": now, "released_at": now,
            "expires_at": 0.0})

    def complete(self, rid: str, now: Optional[float] = None,
                 **info) -> str:
        """Write the done marker (atomic), then sweep the now-inert
        lease epoch files.  Call only after the request's result
        manifest is on disk."""
        now = self._now(now)
        path = self.done_path(rid)
        self.fs.write_atomic(path, _dump_json(
            dict(info, request_id=rid, worker=self.worker,
                 completed_at=now)))
        # every claim checks the done marker before and after acquiring,
        # so once it is on disk the epoch chain is unreachable garbage
        self.fs.unlink_matching(self.root, f"{LEASE_PREFIX}{rid}.e")
        return path

    # -- failure accounting -------------------------------------------

    def record_failure(self, rid: str, error: str,
                       now: Optional[float] = None) -> int:
        """Leave a durable failure marker for one solve attempt (one
        unique file per attempt, so markers from concurrent workers
        never clobber each other) and return the total attempt count.
        Workers release a failed lease for retry until the count
        reaches their attempt budget, then complete the request with an
        error manifest so a poisoned input can't loop forever."""
        path = os.path.join(
            self.root,
            f"{FAIL_PREFIX}{rid}.{self.fs.unique_suffix()}.json")
        self.fs.write_atomic(path, _dump_json({
            "request_id": rid, "worker": self.worker,
            "ts": self._now(now), "error": str(error)[:2000]}))
        return self.failure_count(rid)

    def failure_count(self, rid: str) -> int:
        prefix = f"{FAIL_PREFIX}{rid}."
        return sum(1 for name in self.fs.listdir(self.root)
                   if name.startswith(prefix) and name.endswith(".json"))

    # -- scheduling ----------------------------------------------------

    def select(self, affinity: Set[str] = frozenset(),
               limit: int = 1, now: Optional[float] = None,
               affinity_window_s: float = 10.0) -> List[WorkItem]:
        """Claim candidates in scheduling order: earliest deadline
        first (EDF), with bucket affinity deciding WITHIN a deadline
        window — two items due within ``affinity_window_s`` of each
        other are interchangeable deadline-wise, so the worker prefers
        the one whose shape it already holds an executable for (filling
        its vmapped batch lanes) without ever jumping a strictly
        earlier deadline window.  Does NOT claim — callers iterate the
        returned order and :meth:`claim`."""
        cands = self.pending(now)
        w = max(float(affinity_window_s), 1e-9)

        def key(it: WorkItem):
            dwin = math.floor(it.deadline / w) \
                if math.isfinite(it.deadline) else math.inf
            return (dwin,
                    0 if it.bucket_hint and it.bucket_hint in affinity
                    else 1,
                    it.deadline, it.enqueued_at, it.request_id)

        cands.sort(key=key)
        return cands[:max(int(limit), 0)] if limit else cands
