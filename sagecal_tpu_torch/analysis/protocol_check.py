"""Explicit-state model checker for the fleet coordination protocols
(counterpart of ``sagecal_tpu/analysis/protocol_check.py``, a copy of
its stdlib code run on the port's queue and checkpoint modules).

This module drives the REAL protocol code — :class:`sagecal_tpu_torch.fleet.
queue.LeaseQueue` (claim / renew / steal / release / complete) and the
real stream owner-lease gate :func:`sagecal_tpu_torch.elastic.checkpoint.
check_owner_lease` — through every interleaving of 2–3 logical
workers, with fail-stop crash injection at every filesystem-operation
boundary and logical-clock ticks across lease-TTL expiries, asserting
the protocol invariants at every reachable state.

How interleavings are generated
-------------------------------

Each logical worker runs the unmodified ``LeaseQueue`` methods on a
shared :class:`~sagecal_tpu_torch.analysis.fsmodel.SimFS` behind a per-worker
:class:`_GatedFS` that parks the worker thread at every fs-op boundary.
The controller then explores the choice tree

- ``("step", w)``  — let worker *w* execute exactly one fs op;
- ``("crash", w)`` — fail-stop worker *w* at its pending op (the op
  does not run; staged-but-unpublished state is lost, exactly the
  POSIX crash contract);
- ``("tick",)``    — advance the logical clock to the next lease
  expiry (the only instants at which anything becomes stealable).

by stateless re-execution DFS: a state is a choice prefix, replayed
from the initial state, and deduplicated by fingerprint (visible
files + clock + per-worker program position, beliefs and budgets), so
equivalent interleavings are explored once.

Invariants (checked at EVERY reachable state)
---------------------------------------------

- **no double claim** — at most one live worker believes it holds a
  live lease on a request (beliefs are recorded by the worker script
  at the same logical instant the queue call takes effect);
- **no resurrection** — a renew never succeeds at-or-after the expiry
  the holder believes (expired-is-stable is the property the whole
  steal path leans on);
- **coherence** — if the lease head on disk is live for worker X, no
  other live worker believes it holds that request;
- **no torn/wrong manifest** — every result manifest visible on disk
  at any state parses and equals the deterministic expected content
  (a zombie and a stealer may both write it — atomically, with
  identical bytes);
- **exactly-once completion / no lost item** — a done marker implies
  a valid manifest, and from every reachable state a fresh recovery
  worker (run on a clone of the filesystem, after all leases expire)
  drains the queue: no interleaving or crash can wedge a request
  un-claimably or lose one.

The stream owner-lease model additionally checks that **a live
foreign owner-lease is always refused** at adoption (driving the real
``check_owner_lease``), that a writer never republishes its chain
after its own lease expired (the self-fence), and that adoption
re-validates chain stability after the gate (the stale-read window).

Seeded mutations (``MUTATIONS``) re-introduce each protocol bug the
checker is meant to catch — steal by delete + recreate (the ABA
double-claim), renew without the expiry refusal, claim without
exclusivity, epoch publish with a torn window, non-atomic manifest
writes, adoption without the owner-lease gate, adoption without the
stale-read re-check, a writer without the self-fence — and
``tests/test_protocol.py`` pins that every one is caught.

Stdlib-only, deterministic, CPU-only; the default 2-worker exploration
is bounded well under a minute (see USER_MANUAL.md for the state-space
bounds and the op-granularity argument).
"""

from __future__ import annotations

import dataclasses
import posixpath
import queue as queuelib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from sagecal_tpu_torch.analysis.fsmodel import SimClock, SimCrash, SimFS
from sagecal_tpu_torch.fleet.queue import (
    LEASE_PREFIX,
    LeaseLost,
    LeaseQueue,
    WorkItem,
    _dump_json,
    _parse_json,
)

QUEUE_ROOT = "/q"
OUT_ROOT = "/out"


class CheckerError(RuntimeError):
    """Internal failure of the checker harness itself (never a
    protocol violation)."""


def manifest_path(rid: str) -> str:
    return f"{OUT_ROOT}/result-{rid}.json"


def expected_manifest(rid: str) -> str:
    """Per-request results are deterministic (request-id-derived RNG,
    independent vmapped lanes), so a zombie and a stealer write
    identical bytes; the model's manifest is its stand-in."""
    return _dump_json({"request_id": rid, "verdict": "ok",
                       "solutions": f"gains[{rid}]"})


# ---------------------------------------------------------------------------
# configuration / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckConfig:
    """One queue-exploration scenario."""

    rids: Tuple[str, ...] = ("r1",)
    worker_ids: Tuple[str, ...] = ("wA", "wB")
    ttl_s: float = 10.0
    t0: float = 1000.0
    crash_budget: int = 1
    tick_budget: int = 2
    seed_expired_lease: bool = False   # dead foreign holder at epoch 0
    seed_torn_lease: bool = False      # unparsable garbage head
    torn_manifest: bool = False        # mutation: non-atomic write
    queue_cls: type = LeaseQueue       # mutations swap this
    max_states: int = 500_000
    deadline_s: float = 55.0
    stop_on_first: bool = True


@dataclasses.dataclass
class Violation:
    kind: str
    detail: str
    trace: Tuple[Tuple[Any, ...], ...]  # the choice prefix reaching it

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "detail": self.detail,
                "trace": [list(c) for c in self.trace]}


@dataclasses.dataclass
class Report:
    scenario: str
    violations: List[Violation]
    states: int
    replays: int
    elapsed_s: float
    complete: bool  # False when a state/time bound truncated the DFS

    @property
    def ok(self) -> bool:
        return not self.violations and self.complete

    def to_dict(self) -> Dict[str, Any]:
        return {"scenario": self.scenario, "ok": self.ok,
                "states": self.states, "replays": self.replays,
                "elapsed_s": round(self.elapsed_s, 3),
                "complete": self.complete,
                "violations": [v.to_dict() for v in self.violations]}


def _dedupe(violations: List[Violation]) -> List[Violation]:
    """One Violation per (kind, detail), keeping the shortest trace."""
    best: Dict[Tuple[str, str], Violation] = {}
    for v in violations:
        k = (v.kind, v.detail)
        if k not in best or len(v.trace) < len(best[k].trace):
            best[k] = v
    return list(best.values())


# ---------------------------------------------------------------------------
# the gated worker
# ---------------------------------------------------------------------------

class _Worker:
    """Controller-side state of one logical worker."""

    def __init__(self, wid: str):
        self.wid = wid
        self.parked_op: Optional[Tuple[str, str]] = None
        self.crashed = False
        self.finished = False
        self.failure: Optional[str] = None
        self.beliefs: Dict[str, float] = {}  # rid -> believed expiry
        self.script_violations: List[str] = []
        self.ops = 0  # fs ops executed (program-position surrogate)
        # clock at entry of the in-flight queue call: the call captured
        # its ``now`` there, so two states that differ only in it
        # behave differently and must NOT be deduplicated together
        self.call_clock = 0.0
        self.gate_go = threading.Event()
        self.gate_action = "step"
        self.thread: Optional[threading.Thread] = None
        self.fs = None  # the worker's _GatedFS, set by the script


class _GatedFS:
    """Per-worker view of the shared SimFS: parks the worker thread at
    every op boundary so the controller can schedule or crash it.
    ``makedirs`` (idempotent on the pre-made root — no visible
    transition) and ``unique_suffix`` (pure naming) are not scheduling
    points."""

    def __init__(self, sim: SimFS, worker: _Worker, ctl: "_Execution"):
        self._sim = sim
        self._w = worker
        self._ctl = ctl

    def _gate(self, op: str, detail: str) -> None:
        w = self._w
        w.parked_op = (op, detail)
        self._ctl.msgs.put(("parked", w.wid))
        w.gate_go.wait()
        w.gate_go.clear()
        w.parked_op = None
        if w.gate_action == "crash":
            raise SimCrash(w.wid)
        w.ops += 1

    def makedirs(self, path):
        return self._sim.makedirs(path)

    def unique_suffix(self):
        return self._sim.unique_suffix()

    def exists(self, path):
        self._gate("exists", path)
        return self._sim.exists(path)

    def listdir(self, path):
        self._gate("listdir", path)
        return self._sim.listdir(path)

    def read_text(self, path):
        self._gate("read_text", path)
        return self._sim.read_text(path)

    def open_excl(self, path):
        self._gate("open_excl", path)
        return self._sim.open_excl(path)

    def create(self, path):
        self._gate("create", path)
        return self._sim.create(path)

    def commit(self, fd, text):
        self._gate("commit", getattr(fd, "path", "?"))
        return self._sim.commit(fd, text)

    def publish_excl(self, path, text):
        self._gate("publish_excl", path)
        return self._sim.publish_excl(path, text)

    def write_atomic(self, path, text):
        self._gate("write_atomic", path)
        return self._sim.write_atomic(path, text)

    def unlink(self, path):
        self._gate("unlink", path)
        return self._sim.unlink(path)

    def unlink_matching(self, dirpath, prefix):
        self._gate("unlink_matching", f"{dirpath}/{prefix}*")
        return self._sim.unlink_matching(dirpath, prefix)


def _write_manifest(w: _Worker, rid: str, torn: bool) -> None:
    if torn:
        # mutation: create + write as two separately-visible steps — a
        # reader (or a crash) between them sees a torn manifest
        fd = w.fs.create(manifest_path(rid))
        w.fs.commit(fd, expected_manifest(rid))
    else:
        w.fs.write_atomic(manifest_path(rid), expected_manifest(rid))


def _script_main(w: _Worker, ctl: "_Execution", cfg: CheckConfig) -> None:
    """The worker script: the FleetWorker lifecycle distilled to its
    protocol-visible steps — claim, one mid-solve renew, write the
    result manifest, complete.  Beliefs are recorded at the same
    logical instant the queue call captures its ``now`` (no fs op in
    between, hence no scheduling point in between)."""
    try:
        fs = _GatedFS(ctl.sim, w, ctl)
        w.fs = fs
        q = cfg.queue_cls(QUEUE_ROOT, worker=w.wid, ttl_s=cfg.ttl_s,
                          fs=fs, clock=lambda: ctl.clock.t)
        for rid in cfg.rids:
            t_claim = w.call_clock = ctl.clock.t
            if not q.claim(rid):
                continue
            w.beliefs[rid] = t_claim + q.ttl_s
            try:
                w.call_clock = ctl.clock.t
                exp = q.renew(rid)
            except LeaseLost:
                w.beliefs.pop(rid, None)
                continue
            # renew computed its expiry as now + ttl, so exp - ttl is
            # the instant the renew took effect; succeeding at-or-past
            # the believed expiry means an expired lease was
            # resurrected underneath a stealer's validated observation
            if exp - q.ttl_s >= w.beliefs[rid]:
                w.script_violations.append(
                    f"renew of {rid} by {w.wid} succeeded at "
                    f"t={exp - q.ttl_s:g} at-or-past believed expiry "
                    f"{w.beliefs[rid]:g} (expired leases must be "
                    f"un-renewable)")
            w.beliefs[rid] = exp
            _write_manifest(w, rid, cfg.torn_manifest)
            w.call_clock = ctl.clock.t
            q.complete(rid, verdict="ok")
            w.beliefs.pop(rid, None)
        w.finished = True
        ctl.msgs.put(("done", w.wid))
    except SimCrash:
        w.crashed = True
        w.beliefs.clear()  # a dead process believes nothing
        ctl.msgs.put(("crashed", w.wid))
    except BaseException as e:  # reported as a finding, never lost
        w.failure = f"{type(e).__name__}: {e}"
        ctl.msgs.put(("failed", w.wid))


# ---------------------------------------------------------------------------
# one replayed execution
# ---------------------------------------------------------------------------

class _Execution:
    """Replay of one choice prefix from the initial state."""

    def __init__(self, cfg: CheckConfig,
                 choices: Tuple[Tuple[Any, ...], ...]):
        self.cfg = cfg
        self.sim = SimFS()
        self.clock = SimClock(cfg.t0)
        self.msgs: "queuelib.Queue" = queuelib.Queue()
        self.crash_left = cfg.crash_budget
        self.tick_left = cfg.tick_budget
        self._seed()
        self.workers: Dict[str, _Worker] = {}
        for wid in cfg.worker_ids:
            w = _Worker(wid)
            w.thread = threading.Thread(
                target=_script_main, args=(w, self, cfg), daemon=True)
            self.workers[wid] = w
        for w in self.workers.values():
            w.thread.start()
        self._settle(len(self.workers))
        for c in choices:
            self.apply(c)

    def _seed(self) -> None:
        cfg = self.cfg
        seeder = LeaseQueue(QUEUE_ROOT, worker="seeder",
                            ttl_s=cfg.ttl_s, fs=self.sim,
                            clock=lambda: self.clock.t)
        self.sim.makedirs(OUT_ROOT)
        for rid in cfg.rids:
            seeder.put(WorkItem(request_id=rid, tenant="t", request={}))
        rid0 = cfg.rids[0]
        if cfg.seed_expired_lease:
            # a dead foreign worker's lease, already past its TTL
            self.sim.publish_excl(seeder.lease_path(rid0, 0), _dump_json({
                "worker": "ghost", "request_id": rid0, "epoch": 0,
                "acquired_at": cfg.t0 - cfg.ttl_s - 5.0,
                "renewed_at": cfg.t0 - cfg.ttl_s - 5.0,
                "expires_at": cfg.t0 - 5.0}))
        elif cfg.seed_torn_lease:
            # unparsable garbage at the head (external corruption or
            # an older protocol's torn write): must be claimable
            self.sim.publish_excl(seeder.lease_path(rid0, 0), "")

    # -- controller <-> worker handshakes -----------------------------

    def _settle(self, n: int) -> None:
        for _ in range(n):
            self._recv()

    def _recv(self) -> Tuple[str, str]:
        try:
            return self.msgs.get(timeout=10.0)
        except queuelib.Empty:
            raise CheckerError("worker thread hung (no message in 10s)")

    def _expect_from(self, wid: str) -> None:
        kind, got = self._recv()
        if got != wid:
            raise CheckerError(
                f"message from {got!r} while stepping {wid!r}")

    # -- actions -------------------------------------------------------

    def _next_expiry(self) -> Optional[float]:
        """The earliest future lease-head expiry, or None.  Only head
        epochs matter: non-head epochs are immutable history."""
        heads: Dict[str, Tuple[int, str]] = {}
        for path, text in self.sim.files.items():
            name = posixpath.basename(path)
            if not (name.startswith(LEASE_PREFIX)
                    and name.endswith(".json")):
                continue
            stem = name[len(LEASE_PREFIX):-len(".json")]
            rid, _, e = stem.rpartition(".e")
            try:
                k = int(e)
            except ValueError:
                continue
            if rid not in heads or k > heads[rid][0]:
                heads[rid] = (k, text)
        cands = []
        for _, (_, text) in heads.items():
            doc = _parse_json(text)
            if doc is not None:
                exp = float(doc.get("expires_at", 0.0))
                if exp > self.clock.t:
                    cands.append(exp)
        return min(cands) if cands else None

    def enabled(self) -> List[Tuple[Any, ...]]:
        acts: List[Tuple[Any, ...]] = []
        parked = [wid for wid, w in self.workers.items()
                  if w.parked_op is not None]
        for wid in parked:
            acts.append(("step", wid))
        if self.crash_left > 0:
            for wid in parked:
                acts.append(("crash", wid))
        if self.tick_left > 0 and parked \
                and self._next_expiry() is not None:
            acts.append(("tick",))
        return acts

    def apply(self, act: Tuple[Any, ...]) -> None:
        kind = act[0]
        if kind == "step":
            w = self.workers[act[1]]
            w.gate_action = "step"
            w.gate_go.set()
            self._expect_from(act[1])
        elif kind == "crash":
            self.crash_left -= 1
            w = self.workers[act[1]]
            w.gate_action = "crash"
            w.gate_go.set()
            self._expect_from(act[1])
        elif kind == "tick":
            self.tick_left -= 1
            nxt = self._next_expiry()
            if nxt is not None:
                self.clock.advance_to(nxt)
        else:
            raise CheckerError(f"unknown action {act!r}")

    def teardown(self) -> None:
        """Crash every still-parked worker so its thread exits."""
        waiting = 0
        for w in self.workers.values():
            if w.parked_op is not None and w.thread.is_alive():
                w.gate_action = "crash"
                w.gate_go.set()
                waiting += 1
        for _ in range(waiting):
            self._recv()
        for w in self.workers.values():
            w.thread.join(timeout=5.0)

    # -- state identity ------------------------------------------------

    def fingerprint(self) -> Tuple:
        ws = []
        for wid in self.cfg.worker_ids:
            w = self.workers[wid]
            ws.append((wid, w.crashed, w.finished, w.failure,
                       w.parked_op, w.ops, w.call_clock,
                       tuple(sorted(w.beliefs.items())),
                       tuple(w.script_violations)))
        return (self.sim.fingerprint(), self.clock.t,
                self.crash_left, self.tick_left, tuple(ws))


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def _check_state(ex: _Execution) -> List[Tuple[str, str]]:
    """All invariant violations visible at the current state, as
    (kind, detail) pairs."""
    out: List[Tuple[str, str]] = []
    now = ex.clock.t
    live = {wid: w for wid, w in ex.workers.items() if not w.crashed}

    for w in ex.workers.values():
        for sv in w.script_violations:
            out.append(("renew-past-expiry", sv))
        if w.failure is not None:
            out.append(("worker-exception",
                        f"{w.wid} raised {w.failure}"))

    # no double claim: at most one live worker believes a live lease
    for rid in ex.cfg.rids:
        holders = [wid for wid, w in live.items()
                   if w.beliefs.get(rid, 0.0) > now]
        if len(holders) > 1:
            out.append(("double-claim",
                        f"{holders} all believe they hold {rid} at "
                        f"t={now:g}"))

    # coherence: a live believed holder must own the live on-disk head
    q = LeaseQueue(QUEUE_ROOT, worker="observer", ttl_s=ex.cfg.ttl_s,
                   fs=ex.sim.clone(), clock=lambda: now)
    for rid in ex.cfg.rids:
        doc = q.read_lease(rid)
        if doc is None or float(doc.get("expires_at", 0.0)) <= now:
            continue
        head_worker = doc.get("worker")
        for wid, w in live.items():
            if wid != head_worker and w.beliefs.get(rid, 0.0) > now:
                out.append((
                    "lease-clobbered",
                    f"head of {rid} is live for {head_worker!r} but "
                    f"{wid} also believes it holds it at t={now:g}"))

    # manifests: whenever visible, parsed and byte-identical to the
    # deterministic expected content (torn = violation)
    for path, text in ex.sim.files.items():
        name = posixpath.basename(path)
        if not (name.startswith("result-") and name.endswith(".json")):
            continue
        rid = name[len("result-"):-len(".json")]
        if text != expected_manifest(rid):
            out.append(("torn-manifest",
                        f"manifest {name} holds {text!r} (torn or "
                        f"non-deterministic write)"))

    # done => manifest exists (validity is covered just above)
    for rid in ex.cfg.rids:
        if ex.sim.files.get(q.done_path(rid)) is not None \
                and manifest_path(rid) not in ex.sim.files:
            out.append(("done-without-manifest",
                        f"{rid} has a done marker but no manifest"))
    return out


def _check_recovery(ex: _Execution) -> Optional[str]:
    """From this state, after every lease expires and every worker is
    gone, can a fresh worker drain the queue?  Runs on a CLONE of the
    filesystem (the real execution is not disturbed).  Catches
    livelock (an un-claimably wedged request) and lost items — and
    because it runs at every visited state, it subsumes the
    crash-everyone-then-recover schedules."""
    cfg = ex.cfg
    fs2 = ex.sim.clone()
    t = ex.clock.t
    for path, text in fs2.files.items():
        if posixpath.basename(path).startswith(LEASE_PREFIX):
            doc = _parse_json(text)
            if doc is not None:
                t = max(t, float(doc.get("expires_at", 0.0)))
    tbox = [t + 0.001]
    rq = cfg.queue_cls(QUEUE_ROOT, worker="recovery", ttl_s=cfg.ttl_s,
                       fs=fs2, clock=lambda: tbox[0])
    for _ in range(3 * len(cfg.rids) + 3):
        if rq.all_done():
            break
        progress = False
        for it in rq.items():
            rid = it.request_id
            if fs2.files.get(rq.done_path(rid)) is not None:
                continue
            if rq.claim(rid):
                fs2.write_atomic(manifest_path(rid),
                                 expected_manifest(rid))
                rq.complete(rid, verdict="ok")
                progress = True
        if not progress:
            tbox[0] += cfg.ttl_s + 0.001
    if not rq.all_done():
        return (f"recovery worker cannot drain the queue from this "
                f"state: {rq.stats()} (wedged request — livelock or "
                f"lost item)")
    for rid in cfg.rids:
        if fs2.files.get(manifest_path(rid)) != expected_manifest(rid):
            return f"after recovery, manifest for {rid} is missing/torn"
    return None


# ---------------------------------------------------------------------------
# the queue explorer
# ---------------------------------------------------------------------------

def explore(cfg: CheckConfig, scenario: str = "queue") -> Report:
    """Exhaustive (within budgets) re-execution DFS over the choice
    tree, deduplicated by state fingerprint."""
    t_start = time.monotonic()
    seen = set()
    stack: List[Tuple[Tuple[Any, ...], ...]] = [()]
    violations: List[Violation] = []
    states = replays = 0
    complete = True
    while stack:
        if time.monotonic() - t_start > cfg.deadline_s \
                or states >= cfg.max_states:
            complete = False
            break
        prefix = stack.pop()
        ex = _Execution(cfg, prefix)
        replays += 1
        try:
            fp = ex.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            states += 1
            for kind, detail in _check_state(ex):
                violations.append(Violation(kind, detail, prefix))
            stall = _check_recovery(ex)
            if stall is not None:
                violations.append(
                    Violation("recovery-stall", stall, prefix))
            if violations and cfg.stop_on_first:
                break
            for act in sorted(ex.enabled(), reverse=True):
                stack.append(prefix + (act,))
        finally:
            ex.teardown()
    return Report(scenario=scenario, violations=_dedupe(violations),
                  states=states, replays=replays,
                  elapsed_s=time.monotonic() - t_start,
                  complete=complete)


# ---------------------------------------------------------------------------
# the stream owner-lease model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamConfig:
    """Owner-lease handoff between a writer (w1) checkpointing its
    stream chain and a candidate adopter (w2)."""

    # three windows, so a mid-chain RENEWING write exists between the
    # first checkpoint and the final releasing one — the stale-read
    # fork needs a renewal, not a release, to race the adopter's gate
    windows: int = 3
    ttl_s: float = 10.0
    t0: float = 1000.0
    tick_budget: int = 2
    crash_budget: int = 1
    adopt_checks_lease: bool = True    # False = skip the real gate
    adopt_confirms_chain: bool = True  # stale-read revalidation
    writer_fences: bool = True         # no writes past own expiry
    deadline_s: float = 30.0


def explore_stream(cfg: StreamConfig) -> Report:
    """Explicit-state DFS over the checkpoint-granular actions of one
    writer and one adopter, driving the real
    :func:`~sagecal_tpu_torch.elastic.checkpoint.check_owner_lease` at every
    adoption attempt.  Checkpoint writes are atomic single transitions
    (the real manager writes tmp + fsync + replace), so this
    granularity is exact, not an approximation.

    Adoption is modelled in the three phases the resume path performs:
    read the newest checkpoint meta, run the owner-lease gate, then
    re-read the newest checkpoint and restart if the chain advanced in
    between — the stale-read window this exploration surfaced (a gate
    pass on a stale expired meta while the writer had already renewed
    would otherwise fork the chain)."""
    from sagecal_tpu_torch.elastic.checkpoint import (
        ResumeRefused,
        check_owner_lease,
    )

    t_start = time.monotonic()
    violations: List[Violation] = []
    seen = set()
    adoptions = 0
    complete = True

    # state: (t, ckpts, (w1_next, w1_alive, w1_fenced),
    #         (w2_read, w2_checked, w2_adopted),
    #         tick_left, crash_left)
    # ckpts: sorted tuple of (index, owner, lease_expires, windows_done)
    init = (cfg.t0, (), (0, True, False), (None, False, False),
            cfg.tick_budget, cfg.crash_budget)
    stack: List[Tuple[Tuple, Tuple]] = [(init, ())]

    def newest(ckpts):
        return ckpts[-1] if ckpts else None

    while stack:
        if time.monotonic() - t_start > cfg.deadline_s:
            complete = False
            break
        state, trace = stack.pop()
        if state in seen:
            continue
        seen.add(state)
        (t, ckpts, (w1_next, w1_alive, w1_fenced),
         (w2_read, w2_checked, w2_adopted), tick_left,
         crash_left) = state

        succs: List[Tuple[Tuple[Any, ...], Tuple]] = []

        # -- writer: checkpoint the next window (implicit lease renew;
        #    the final window releases with lease 0.0)
        if w1_alive and not w1_fenced and w1_next < cfg.windows:
            prev = None
            for c in ckpts:
                if c[1] == "w1":
                    prev = c
            stalled = prev is not None and 0.0 < prev[2] <= t
            if cfg.writer_fences and stalled:
                # the self-fence: own lease expired while stalled —
                # stop republishing the chain (a successor may own it)
                succs.append((("w1_fence",),
                              (t, ckpts, (w1_next, True, True),
                               (w2_read, w2_checked, w2_adopted),
                               tick_left, crash_left)))
            else:
                if stalled:
                    violations.append(Violation(
                        "writer-resurrected-chain",
                        f"w1 republished its chain at t={t:g} after "
                        f"its own lease expired at {prev[2]:g}",
                        trace + (("w1_write", w1_next),)))
                final = w1_next == cfg.windows - 1
                lease = 0.0 if final else t + cfg.ttl_s
                nc = tuple(sorted(
                    [c for c in ckpts if c[0] != w1_next]
                    + [(w1_next, "w1", lease, w1_next + 1)]))
                succs.append((("w1_write", w1_next),
                              (t, nc, (w1_next + 1, True, w1_fenced),
                               (w2_read, w2_checked, w2_adopted),
                               tick_left, crash_left)))

        # -- writer crash
        if w1_alive and crash_left > 0:
            succs.append((("w1_crash",),
                          (t, ckpts, (w1_next, False, w1_fenced),
                           (w2_read, w2_checked, w2_adopted),
                           tick_left, crash_left - 1)))

        # -- adopter phase 1: read the newest checkpoint meta
        if not w2_adopted and ckpts and w2_read is None:
            succs.append((("w2_read",),
                          (t, ckpts, (w1_next, w1_alive, w1_fenced),
                           (newest(ckpts), False, False),
                           tick_left, crash_left)))

        # -- adopter phase 2: the owner-lease gate (REAL code)
        if not w2_adopted and w2_read is not None and not w2_checked:
            _, owner, expires, _ = w2_read
            if cfg.adopt_checks_lease:
                try:
                    check_owner_lease(
                        {"owner": owner, "lease_expires_at": expires},
                        "w2", now=t)
                    passed = True
                except ResumeRefused:
                    passed = False
            else:
                passed = True  # mutation: gate skipped entirely
            if passed:
                succs.append((("w2_gate_pass",),
                              (t, ckpts,
                               (w1_next, w1_alive, w1_fenced),
                               (w2_read, True, False),
                               tick_left, crash_left)))
            else:
                succs.append((("w2_gate_refused",),
                              (t, ckpts,
                               (w1_next, w1_alive, w1_fenced),
                               (None, False, False),
                               tick_left, crash_left)))

        # -- adopter phase 3: confirm chain stability, then adopt
        if not w2_adopted and w2_read is not None and w2_checked:
            cur = newest(ckpts)
            if cfg.adopt_confirms_chain and cur != w2_read:
                # chain advanced between gate and adoption: restart
                succs.append((("w2_restart",),
                              (t, ckpts,
                               (w1_next, w1_alive, w1_fenced),
                               (None, False, False),
                               tick_left, crash_left)))
            else:
                head = newest(ckpts)
                if head is not None and head[1] not in ("", "w2") \
                        and head[2] > t and w1_alive and not w1_fenced:
                    violations.append(Violation(
                        "adopted-live-foreign-lease",
                        f"w2 adopted the chain at t={t:g} while "
                        f"{head[1]}'s lease is live until "
                        f"{head[2]:g} and its holder can still write",
                        trace + (("w2_adopt",),)))
                adoptions += 1
                wd = w2_read[3]
                nc = tuple(sorted(
                    [c for c in ckpts if c[0] != wd]
                    + [(wd, "w2", t + cfg.ttl_s, wd + 1)]))
                succs.append((("w2_adopt",),
                              (t, nc, (w1_next, w1_alive, w1_fenced),
                               (None, False, True),
                               tick_left, crash_left)))

        # -- logical time: the next lease expiry AND a mid-TTL point.
        #    The mid-TTL target matters: a writer renewing between two
        #    expiries produces overlapping leases with distinct
        #    deadlines, which is exactly the shape of the stale-read
        #    fork; expiry-only ticking can never construct it.
        if tick_left > 0:
            targets = {t + cfg.ttl_s / 2.0}
            exps = [c[2] for c in ckpts if c[2] > t]
            if exps:
                targets.add(min(exps))
            for tgt in sorted(targets):
                succs.append((("tick", tgt),
                              (tgt, ckpts,
                               (w1_next, w1_alive, w1_fenced),
                               (w2_read, w2_checked, w2_adopted),
                               tick_left - 1, crash_left)))

        for act, ns in succs:
            stack.append((ns, trace + (act,)))

    if cfg.adopt_checks_lease and cfg.adopt_confirms_chain \
            and adoptions == 0:
        violations.append(Violation(
            "adoption-unreachable",
            "no explored schedule ever adopted the chain — the "
            "owner-lease gate is vacuously strict", ()))
    return Report(scenario="stream-owner-lease",
                  violations=_dedupe(violations), states=len(seen),
                  replays=len(seen),
                  elapsed_s=time.monotonic() - t_start,
                  complete=complete)


# ---------------------------------------------------------------------------
# seeded mutations: each re-introduces one protocol bug
# ---------------------------------------------------------------------------

class _MutantStealByDelete(LeaseQueue):
    """Mutation: steal by unlinking the dead lease and re-creating the
    SAME name (the pre-epoch-chain protocol).  Two stealers that both
    read the dead lease race the unlink: the slower one deletes the
    winner's freshly created LIVE lease (unlink acts on the name, not
    on the content that was validated) and claims on top — the ABA
    double claim."""

    def claim(self, rid, now=None):
        now = self._now(now)
        if self.fs.exists(self.done_path(rid)):
            return False
        epoch, doc = self._lease_head(rid)
        if self._live(doc, now):
            return False
        if epoch >= 0:
            try:
                self.fs.unlink(self.lease_path(rid, epoch))
            except OSError:
                pass
        try:
            self.fs.publish_excl(
                self.lease_path(rid, max(epoch, 0)), _dump_json({
                    "worker": self.worker, "request_id": rid,
                    "epoch": max(epoch, 0), "acquired_at": now,
                    "renewed_at": now, "expires_at": now + self.ttl_s}))
        except (FileExistsError, OSError):
            return False
        return True


class _MutantRenewPastTTL(LeaseQueue):
    """Mutation: renew without the expiry refusal — an expired lease
    can be resurrected by its old holder, so "this head is expired" is
    no longer a stable observation."""

    def renew(self, rid, now=None):
        now = self._now(now)
        epoch, doc = self._lease_head(rid)
        if doc is None or doc.get("worker") != self.worker:
            raise LeaseLost(f"lease on {rid} lost")
        doc = dict(doc, renewed_at=now, expires_at=now + self.ttl_s)
        if not self._advance(rid, epoch, doc):
            raise LeaseLost(f"lease on {rid} lost")
        return doc["expires_at"]


class _MutantClaimNoExcl(LeaseQueue):
    """Mutation: advance the chain with a plain truncating create
    instead of an exclusive publish — every racer "wins", so two
    workers both believe they claimed."""

    def _advance(self, rid, epoch, doc):
        fd = self.fs.create(self.lease_path(rid, epoch + 1))
        self.fs.commit(fd, _dump_json(dict(doc, epoch=epoch + 1)))
        return True


class _MutantTornPublish(LeaseQueue):
    """Mutation: advance the chain with ``O_CREAT|O_EXCL`` followed by
    a separate content write.  The head is visible-but-empty between
    the two ops; a peer that reads the torn head treats the lease as
    dead and advances over it while its creator is alive mid-write —
    double claim.  This is why the shipped protocol publishes epoch
    files via the atomic hard-link publish instead."""

    def _advance(self, rid, epoch, doc):
        try:
            fd = self.fs.open_excl(self.lease_path(rid, epoch + 1))
        except (FileExistsError, OSError):
            return False
        self.fs.commit(fd, _dump_json(dict(doc, epoch=epoch + 1)))
        return True


def _mut_steal_by_delete(**kw) -> Report:
    cfg = CheckConfig(queue_cls=_MutantStealByDelete,
                      seed_expired_lease=True, crash_budget=0,
                      tick_budget=0, **kw)
    return explore(cfg, scenario="mutation:steal-by-delete")


def _mut_renew_past_ttl(**kw) -> Report:
    cfg = CheckConfig(queue_cls=_MutantRenewPastTTL,
                      worker_ids=("wA",), crash_budget=0,
                      tick_budget=2, **kw)
    return explore(cfg, scenario="mutation:renew-past-ttl")


def _mut_claim_no_excl(**kw) -> Report:
    cfg = CheckConfig(queue_cls=_MutantClaimNoExcl, crash_budget=0,
                      tick_budget=0, **kw)
    return explore(cfg, scenario="mutation:claim-no-excl")


def _mut_torn_publish(**kw) -> Report:
    cfg = CheckConfig(queue_cls=_MutantTornPublish, crash_budget=0,
                      tick_budget=0, **kw)
    return explore(cfg, scenario="mutation:torn-publish")


def _mut_torn_manifest(**kw) -> Report:
    cfg = CheckConfig(torn_manifest=True, worker_ids=("wA",),
                      crash_budget=1, tick_budget=0, **kw)
    return explore(cfg, scenario="mutation:torn-manifest")


def _mut_adopt_without_check(**kw) -> Report:
    return explore_stream(StreamConfig(adopt_checks_lease=False, **kw))


def _mut_adopt_stale_read(**kw) -> Report:
    return explore_stream(StreamConfig(adopt_confirms_chain=False,
                                       **kw))


def _mut_writer_no_fence(**kw) -> Report:
    return explore_stream(StreamConfig(writer_fences=False, **kw))


#: name -> runner; each re-introduces one protocol bug the checker
#: must catch (pinned by tests/test_protocol.py)
MUTATIONS: Dict[str, Callable[..., Report]] = {
    "steal-by-delete": _mut_steal_by_delete,
    "renew-past-ttl": _mut_renew_past_ttl,
    "claim-no-excl": _mut_claim_no_excl,
    "torn-publish": _mut_torn_publish,
    "torn-manifest": _mut_torn_manifest,
    "adopt-without-owner-check": _mut_adopt_without_check,
    "adopt-stale-read": _mut_adopt_stale_read,
    "writer-no-fence": _mut_writer_no_fence,
}


def run_mutation(name: str, **kw) -> Report:
    if name not in MUTATIONS:
        raise KeyError(f"unknown mutation {name!r} "
                       f"(have {sorted(MUTATIONS)})")
    return MUTATIONS[name](**kw)


# ---------------------------------------------------------------------------
# the default check (diag protocol / CI)
# ---------------------------------------------------------------------------

def default_scenarios(workers: int = 2, crash_budget: int = 1,
                      tick_budget: int = 2
                      ) -> List[Tuple[str, CheckConfig]]:
    wids = tuple(f"w{chr(ord('A') + i)}" for i in range(workers))
    base = dict(worker_ids=wids, crash_budget=crash_budget,
                tick_budget=tick_budget)
    return [
        ("fresh-item", CheckConfig(**base)),
        ("expired-foreign-lease",
         CheckConfig(seed_expired_lease=True, **base)),
        ("garbage-lease-head",
         CheckConfig(seed_torn_lease=True, **base)),
    ]


def run_protocol_check(workers: int = 2, crash_budget: int = 1,
                       tick_budget: int = 2, deadline_s: float = 55.0,
                       log=print) -> Dict[str, Any]:
    """The full default suite: every queue scenario exhaustively, plus
    the stream owner-lease model.  ``ok`` is True iff every scenario
    completed within budget with zero violations."""
    t0 = time.monotonic()
    reports: List[Report] = []
    for name, cfg in default_scenarios(workers, crash_budget,
                                       tick_budget):
        cfg.deadline_s = max(deadline_s - (time.monotonic() - t0), 5.0)
        rep = explore(cfg, scenario=name)
        reports.append(rep)
        log(f"protocol: {name}: {rep.states} states, "
            f"{rep.replays} replays, {rep.elapsed_s:.1f}s, "
            f"{'OK' if rep.ok else 'VIOLATED' if rep.violations else 'TRUNCATED'}")
    srep = explore_stream(StreamConfig())
    reports.append(srep)
    log(f"protocol: {srep.scenario}: {srep.states} states, "
        f"{srep.elapsed_s:.1f}s, {'OK' if srep.ok else 'VIOLATED'}")
    return {
        "ok": all(r.ok for r in reports),
        "workers": workers,
        "states": sum(r.states for r in reports),
        "replays": sum(r.replays for r in reports),
        "elapsed_s": round(time.monotonic() - t0, 3),
        "scenarios": [r.to_dict() for r in reports],
    }
