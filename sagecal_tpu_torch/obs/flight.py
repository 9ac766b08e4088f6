"""In-process flight recorder: ring buffer, heartbeat, hang watchdog,
crash dumps (counterpart of ``sagecal_tpu/obs/flight.py``, copied).

A watch script can only observe a run from outside; when a run hangs in
a wedged device call or dies on an uncaught exception, the interesting
state is *inside* the process.  A
:class:`FlightRecorder` keeps:

- a bounded ring buffer of recent activity records (spans, phases,
  events; ``SAGECAL_FLIGHT_RING`` entries, default 256);
- a heartbeat file (``SAGECAL_HEARTBEAT_FILE``, default
  ``.sagecal_heartbeat``) rewritten atomically by a daemon watchdog
  thread — watch scripts treat a *fresh mtime* as "process alive" (a
  hard hang that stops the watchdog thread also stops the mtime, so
  staleness is a honest kill signal);
- a hang watchdog: if no activity is recorded for
  ``SAGECAL_STALL_SECONDS`` (default 300) the recorder dumps all-thread
  Python stacks, the ring tail, and (when torch is already imported and
  CUDA already initialized) the CUDA device's name, count and allocated
  memory to ``flight_dump.json`` — it does NOT kill the run, and
  records ``stall_resolved`` if activity resumes;
- crash handlers: :func:`install_crash_handlers` chains a process-wide
  ``sys.excepthook`` and a SIGTERM handler that write a flight dump,
  run every registered crash flusher (the elastic checkpoint manager
  registers one, so a preempted run persists its last completed tile),
  reap active tile-prefetch threads, flush every registered JSONL
  event log with a ``run_aborted`` event carrying the dump path, then
  defer to the previous handler.

Everything is host-side, stdlib-only at import time, and inert unless
``SAGECAL_FLIGHT=1`` (crash handlers still flush event logs without a
recorder; the dump path is simply absent).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

# v2: dumps carry a writer-identity stamp (obs/ledger.py accepts both)
DUMP_SCHEMA_VERSION = 2

_TRUTHY = ("1", "true", "yes", "on")

DEFAULT_RING = 256
DEFAULT_STALL_SECONDS = 300.0
DEFAULT_HEARTBEAT_FILE = ".sagecal_heartbeat"
DEFAULT_DUMP_FILE = "flight_dump.json"


def _env_enabled() -> bool:
    return os.environ.get("SAGECAL_FLIGHT", "").strip().lower() in _TRUTHY


_enabled: Optional[bool] = None


def flight_enabled() -> bool:
    """Master flight-recorder switch: ``set_flight`` override if set,
    otherwise the ``SAGECAL_FLIGHT`` env var."""
    if _enabled is not None:
        return _enabled
    return _env_enabled()


def set_flight(on: Optional[bool]) -> None:
    """Force the flight recorder on/off (``None`` restores env-var
    control)."""
    global _enabled
    _enabled = on


def _jsonable(x):
    from sagecal_tpu_torch.obs.events import _jsonable as ev_jsonable

    return ev_jsonable(x)


# last elastic checkpoint written/resumed in this process; flight dumps
# and heartbeats carry it so `diag flight` can point an operator at the
# exact file a `--resume` restart will pick up
_LAST_CHECKPOINT: Optional[str] = None


def note_checkpoint(path: str) -> None:
    """Record the most recent checkpoint path (elastic/checkpoint.py
    calls this on every write and on resume)."""
    global _LAST_CHECKPOINT
    _LAST_CHECKPOINT = path
    fr = _GLOBAL
    if fr is not None:
        fr.record("checkpoint", name=os.path.basename(path), path=path)


def last_checkpoint_path() -> Optional[str]:
    return _LAST_CHECKPOINT


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def _thread_stacks() -> List[dict]:
    """All-thread Python stacks via ``sys._current_frames`` (the same
    state ``faulthandler`` prints, but structured)."""
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        name, daemon = names.get(tid, ("?", False))
        out.append({
            "tid": tid,
            "name": name,
            "daemon": daemon,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return out


def _device_state() -> dict:
    """CUDA device snapshot — guarded: torch is queried only when it is
    ALREADY imported and CUDA ALREADY initialized (a dump must never be
    the thing that initializes a wedged device), and nothing here
    synchronizes."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"torch_imported": False}
    out: Dict[str, Any] = {"torch_imported": True}
    try:
        if not torch.cuda.is_initialized():
            out["cuda_initialized"] = False
            return out
        out["cuda_initialized"] = True
        out["platform"] = "gpu"
        out["num_devices"] = torch.cuda.device_count()
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["memory_allocated"] = int(torch.cuda.memory_allocated())
        out["max_memory_allocated"] = int(torch.cuda.max_memory_allocated())
    except Exception as e:
        out["device_error"] = f"{type(e).__name__}: {e}"
    return out


def _device_profile_trace() -> Optional[str]:
    """Newest device-profile trace when capture was armed — guarded
    like :func:`_device_state`: only consulted when devprof is ALREADY
    imported, so the crash path never imports anything new."""
    devprof = sys.modules.get("sagecal_tpu_torch.obs.devprof")
    if devprof is None:
        return None
    try:
        path = devprof.last_trace_path()
        if path:
            return path
        root = os.environ.get("SAGECAL_DEVICE_PROFILE")
        if root and os.path.isdir(root):
            return devprof.newest_trace_path(root)
    except Exception:
        pass
    return None


class FlightRecorder:
    """Bounded activity ring + heartbeat file + hang watchdog."""

    def __init__(self,
                 heartbeat_path: Optional[str] = None,
                 dump_path: Optional[str] = None,
                 ring_size: Optional[int] = None,
                 stall_seconds: Optional[float] = None,
                 run_id: Optional[str] = None):
        env = os.environ
        self.heartbeat_path = heartbeat_path or env.get(
            "SAGECAL_HEARTBEAT_FILE") or DEFAULT_HEARTBEAT_FILE
        self.dump_path = dump_path or env.get(
            "SAGECAL_FLIGHT_DUMP") or DEFAULT_DUMP_FILE
        if ring_size is None:
            try:
                ring_size = int(env.get("SAGECAL_FLIGHT_RING", ""))
            except ValueError:
                ring_size = DEFAULT_RING
        if stall_seconds is None:
            try:
                stall_seconds = float(env.get("SAGECAL_STALL_SECONDS", ""))
            except ValueError:
                stall_seconds = DEFAULT_STALL_SECONDS
        self.ring_size = max(int(ring_size), 8)
        self.stall_seconds = float(stall_seconds)
        self.run_id = run_id or ""
        self._ring: collections.deque = collections.deque(
            maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._last_activity = time.monotonic()
        self._last_beat = 0.0
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dumps: List[str] = []

    # -- activity -----------------------------------------------------

    def record(self, kind: str, name: str = "", **fields) -> None:
        """Record one activity entry; refreshes the stall clock and
        closes an open stall window (``stall_resolved``)."""
        self._append(kind, name, **fields)
        self._last_activity = time.monotonic()
        if self._stalled:
            self._stalled = False
            self._append("stall_resolved", name,
                         stall_seconds=self.stall_seconds)
        # opportunistic beat so short-lived processes leave a heartbeat
        # even before the watchdog's first tick (rate-limited to 1/s)
        now = time.monotonic()
        if now - self._last_beat >= 1.0:
            self.heartbeat()

    def _append(self, kind: str, name: str = "", **fields) -> None:
        entry = {"ts": time.time(), "kind": kind, "name": name}
        for k, v in fields.items():
            if k not in entry:
                entry[k] = _jsonable(v)
        with self._lock:
            self._ring.append(entry)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def seconds_since_activity(self) -> float:
        return time.monotonic() - self._last_activity

    # -- heartbeat ----------------------------------------------------

    def heartbeat(self, closed: bool = False) -> None:
        """Atomically rewrite the heartbeat file.  Watch scripts key on
        the file *mtime*; the JSON body carries the
        richer state for humans and ``diag``."""
        doc = {
            "pid": os.getpid(),
            "ts": time.time(),
            "run_id": self.run_id,
            "last_activity_age": round(self.seconds_since_activity(), 3),
            "stalled": self._stalled,
            "ring_len": len(self._ring),
            "closed": closed,
            "last_checkpoint": _LAST_CHECKPOINT,
        }
        try:
            _atomic_write_json(self.heartbeat_path, doc)
            self._last_beat = time.monotonic()
        except OSError:
            pass

    # -- watchdog -----------------------------------------------------

    def start(self, poll_seconds: Optional[float] = None) -> None:
        """Start the daemon watchdog thread (idempotent): writes the
        heartbeat every poll and dumps once per stall window when no
        activity arrives for ``stall_seconds``."""
        if self._thread is not None and self._thread.is_alive():
            return
        if poll_seconds is None:
            poll_seconds = max(0.05, min(self.stall_seconds / 4.0, 10.0))
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, args=(float(poll_seconds),),
            name="sagecal-flight-watchdog", daemon=True)
        self._thread.start()

    def _watch(self, poll_seconds: float) -> None:
        while not self._stop.wait(poll_seconds):
            self.heartbeat()
            if (not self._stalled
                    and self.seconds_since_activity() > self.stall_seconds):
                self._stalled = True
                self._append("hang_detected",
                             stall_seconds=self.stall_seconds,
                             idle_seconds=round(
                                 self.seconds_since_activity(), 3))
                try:
                    self.dump("stall")
                except Exception:
                    pass

    def stop(self) -> None:
        """Stop the watchdog and leave a final ``closed`` heartbeat so
        watch scripts can tell clean shutdown from death."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        self.heartbeat(closed=True)

    # -- dumps --------------------------------------------------------

    def dump(self, reason: str, exc_info=None) -> str:
        """Write the forensic dump (all-thread stacks + ring tail +
        guarded device state) atomically to :attr:`dump_path`."""
        doc: Dict[str, Any] = {
            "schema_version": DUMP_SCHEMA_VERSION,
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "run_id": self.run_id,
            "argv": list(sys.argv),
            "stall_seconds": self.stall_seconds,
            "last_activity_age": round(self.seconds_since_activity(), 3),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith("SAGECAL_")
                    or k == "CUDA_VISIBLE_DEVICES"},
            "threads": _thread_stacks(),
            "ring": self.snapshot(),
            "device_state": _device_state(),
            "last_checkpoint": _LAST_CHECKPOINT,
            "device_profile_trace": _device_profile_trace(),
        }
        from sagecal_tpu_torch.obs.events import writer_identity

        doc["writer"] = writer_identity()
        doc["mono"] = time.monotonic()
        if exc_info is not None:
            tp, val, tb = exc_info
            doc["exception"] = {
                "type": getattr(tp, "__name__", str(tp)),
                "value": str(val),
                "traceback": traceback.format_exception(tp, val, tb),
            }
        _atomic_write_json(self.dump_path, doc)
        self.dumps.append(self.dump_path)
        return self.dump_path


_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def get_flight_recorder(run_id: Optional[str] = None
                        ) -> Optional[FlightRecorder]:
    """The process flight recorder, started on first use, when
    ``SAGECAL_FLIGHT=1``; None when disabled."""
    global _GLOBAL
    if not flight_enabled():
        return None
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = FlightRecorder(run_id=run_id)
            _GLOBAL.start()
        elif run_id and not _GLOBAL.run_id:
            _GLOBAL.run_id = run_id
        return _GLOBAL


def active_recorder() -> Optional[FlightRecorder]:
    """The already-started recorder, if any — never creates one (so
    library call sites can feed activity without owning lifecycle)."""
    return _GLOBAL


def note_activity(kind: str, name: str = "", **fields) -> None:
    """Feed one activity record to the active recorder (no-op without
    one).  Called from tracer span exits and app phase loops."""
    fr = _GLOBAL
    if fr is not None:
        fr.record(kind, name, **fields)


def reset_flight_recorder() -> None:
    """Stop and drop the process recorder (tests)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        fr, _GLOBAL = _GLOBAL, None
    if fr is not None:
        fr.stop()


def close_flight_recorder() -> None:
    """Clean-shutdown counterpart of :func:`get_flight_recorder`: stop
    the watchdog and leave the final ``closed`` heartbeat so watch
    scripts can tell a finished run from a dead one.  Apps call this
    only on the SUCCESS path — a crash must leave the recorder (and
    its ring) alive for the excepthook's dump."""
    reset_flight_recorder()


# ---------------------------------------------------------------------------
# crash handlers: excepthook + SIGTERM -> dump + event-log flush


# Event logs to flush on crash.  Plain list (not weak): apps register
# right after opening and the set stays tiny; closed logs are skipped.
_EVENT_LOGS: List[Any] = []
_PREV_EXCEPTHOOK = None
_PREV_SIGTERM = None
_INSTALLED = False


def register_event_log(elog) -> None:
    """Register a JSONL event log for crash-time flushing."""
    if elog is not None and elog not in _EVENT_LOGS:
        _EVENT_LOGS.append(elog)


def unregister_event_log(elog) -> None:
    try:
        _EVENT_LOGS.remove(elog)
    except ValueError:
        pass


def _flush_event_logs(reason: str, dump_path: Optional[str]) -> None:
    for elog in list(_EVENT_LOGS):
        try:
            if getattr(elog, "closed", False):
                continue
            elog.emit("run_aborted", reason=reason, flight_dump=dump_path,
                      last_checkpoint=_LAST_CHECKPOINT)
            elog.close()
        except Exception:
            pass


# Crash flushers run BEFORE the event logs close so their own events
# (checkpoint_written) still land in the log; the elastic checkpoint
# manager is the canonical registrant.  Same plain-list pattern as
# _EVENT_LOGS.
_CRASH_FLUSHERS: List[Any] = []


def register_crash_flusher(fn) -> None:
    """Register a zero-arg callable invoked from the SIGTERM/excepthook
    path (exceptions swallowed — a flusher must never mask the crash)."""
    if fn is not None and fn not in _CRASH_FLUSHERS:
        _CRASH_FLUSHERS.append(fn)


def unregister_crash_flusher(fn) -> None:
    try:
        _CRASH_FLUSHERS.remove(fn)
    except ValueError:
        pass


def _run_crash_flushers() -> None:
    for fn in list(_CRASH_FLUSHERS):
        try:
            fn()
        except Exception:
            pass
    # reap tile-prefetch worker threads so teardown can't hang past the
    # checkpoint flush; guarded on the module being loaded already (the
    # crash path must never import h5py/torch into a dying process)
    ds_mod = sys.modules.get("sagecal_tpu_torch.io.dataset")
    if ds_mod is not None:
        try:
            ds_mod.cancel_active_prefetchers()
        except Exception:
            pass


def _crash_dump(reason: str, exc_info=None) -> Optional[str]:
    fr = _GLOBAL if _GLOBAL is not None else get_flight_recorder()
    if fr is None:
        return None
    try:
        return fr.dump(reason, exc_info=exc_info)
    except Exception:
        return None


def _excepthook(tp, val, tb) -> None:
    _run_crash_flushers()  # before the dump: it records last_checkpoint
    path = _crash_dump("uncaught_exception", exc_info=(tp, val, tb))
    _flush_event_logs(f"uncaught_exception:{getattr(tp, '__name__', tp)}",
                      path)
    hook = _PREV_EXCEPTHOOK or sys.__excepthook__
    hook(tp, val, tb)


def _sigterm_handler(signum, frame) -> None:
    # checkpoint first: the dump/flush below is forensics, the flusher
    # is the state a `--resume` restart needs to exist
    _run_crash_flushers()
    path = _crash_dump("sigterm")
    _flush_event_logs("sigterm", path)
    prev = _PREV_SIGTERM
    if callable(prev):
        prev(signum, frame)
        return
    # restore the previous disposition and re-deliver so the process
    # still dies with the default SIGTERM exit status
    signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install_crash_handlers() -> None:
    """Install the process-wide ``sys.excepthook`` + SIGTERM handler
    (idempotent; both chain to whatever was installed before).  Called
    from every app entrypoint so an uncaught exception can no longer
    lose buffered events."""
    global _INSTALLED, _PREV_EXCEPTHOOK, _PREV_SIGTERM
    if _INSTALLED:
        return
    _PREV_EXCEPTHOOK = sys.excepthook
    sys.excepthook = _excepthook
    try:  # signal handlers only installable from the main thread
        _PREV_SIGTERM = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _sigterm_handler)
    except ValueError:
        _PREV_SIGTERM = None
    _INSTALLED = True


def uninstall_crash_handlers() -> None:
    """Restore the previous excepthook / SIGTERM handler (tests)."""
    global _INSTALLED, _PREV_EXCEPTHOOK, _PREV_SIGTERM
    if not _INSTALLED:
        return
    if sys.excepthook is _excepthook and _PREV_EXCEPTHOOK is not None:
        sys.excepthook = _PREV_EXCEPTHOOK
    try:
        if signal.getsignal(signal.SIGTERM) is _sigterm_handler:
            signal.signal(signal.SIGTERM,
                          _PREV_SIGTERM if _PREV_SIGTERM is not None
                          else signal.SIG_DFL)
    except ValueError:
        pass
    _PREV_EXCEPTHOOK = None
    _PREV_SIGTERM = None
    _INSTALLED = False


# ---------------------------------------------------------------------------
# dump readers (diag flight)


def read_dump(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def format_dump(doc: dict, ring_tail: int = 20) -> str:
    """Human rendering of a flight dump for ``diag flight``."""
    lines = [
        f"flight dump: reason={doc.get('reason', '?')} "
        f"pid={doc.get('pid')} run_id={doc.get('run_id') or '-'}",
        f"written: {time.strftime('%Y-%m-%d %H:%M:%SZ', time.gmtime(doc.get('ts', 0)))}"
        f"  last activity {doc.get('last_activity_age', '?')}s before dump",
    ]
    exc = doc.get("exception")
    if exc:
        lines.append(f"exception: {exc.get('type')}: {exc.get('value')}")
    ckpt = doc.get("last_checkpoint")
    lines.append(
        f"last checkpoint: {ckpt} (restart with --resume)" if ckpt
        else "last checkpoint: none (run had no checkpointing enabled)")
    dp = doc.get("device_profile_trace")
    if dp:
        lines.append(f"device-profile trace: {dp} "
                     f"(feed to `diag roofline`)")
    dev = doc.get("device_state") or {}
    if dev.get("cuda_initialized"):
        lines.append(
            f"devices: {dev.get('num_devices', '?')}x "
            f"{dev.get('device_kind', '?')} ({dev.get('platform', '?')}), "
            f"allocated {dev.get('memory_allocated', '?')} bytes, peak "
            f"{dev.get('max_memory_allocated', '?')} bytes")
    elif dev.get("torch_imported"):
        lines.append("devices: CUDA not initialized at dump time")
    else:
        lines.append("devices: torch not imported at dump time")
    threads = doc.get("threads") or []
    lines.append(f"threads: {len(threads)}")
    for t in threads:
        tag = " [daemon]" if t.get("daemon") else ""
        lines.append(f"--- thread {t.get('name', '?')} "
                     f"(tid={t.get('tid')}){tag}")
        for frame_line in t.get("stack", []):
            for sub in frame_line.split("\n"):
                if sub.strip():
                    lines.append("    " + sub.strip())
    ring = doc.get("ring") or []
    lines.append(f"ring buffer: {len(ring)} entries "
                 f"(last {min(ring_tail, len(ring))} shown)")
    for e in ring[-ring_tail:]:
        ts = time.strftime("%H:%M:%S", time.gmtime(e.get("ts", 0)))
        extra = {k: v for k, v in e.items()
                 if k not in ("ts", "kind", "name")}
        lines.append(f"  {ts}  {e.get('kind', '?'):<16s} "
                     f"{e.get('name', ''):<24s} "
                     f"{json.dumps(extra) if extra else ''}".rstrip())
    return "\n".join(lines)
