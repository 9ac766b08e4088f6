"""Device profiles: capture with ``torch.profiler``, parse Kineto's trace,
attribute device time to the kernel table's rows (counterpart of
``sagecal_tpu/obs/devprof.py``).

- **Capture.**  :func:`start_device_profile` / :func:`stop_device_profile`
  / :func:`device_profile` run a ``torch.profiler`` session (CPU and,
  on the card, CUDA activities) with the reference's idempotent-owner
  discipline, opted in by ``SAGECAL_DEVICE_PROFILE=dir`` or the CLI's
  ``--device-profile``, and write a gzipped Chrome trace into the
  directory.  A profile that cannot see the card raises with the cause:
  a torch without CUPTI (no CUDA activity) refuses to start, and a CUDA
  capture whose trace holds no kernel event raises at stop; it never
  leaves a trace without device events behind as if it were one.
  ``SAGECAL_DEVICE_PROFILE_CPU=0`` records the card's activity alone
  (kernels, copies, the runtime's launch calls): a full-width tile's
  trace shrinks from ~2.1 M events to a few hundred thousand, and its
  kernels join their rows by launch order.  :func:`capture_stats` gives
  the last export's events, bytes and seconds.
- **Kernel rows.**  While a capture is active, every kernel wrapper runs
  inside ``torch.profiler.record_function("sagecal::#<row> <name>")``
  (:func:`launch_annotation`; a shared no-op otherwise, so the path
  without a profile is untouched).  A kernel name alone does not give
  the row: the gradient and sum kernels of ``csrc/fused_cost.cu`` serve
  #4, #6 and #2.
- **Fleet arming** (:func:`arm_fleet_profile`, :func:`check_fleet_arm`,
  :func:`complete_fleet_arm`): the reference's flag-file protocol, file
  for file.
- **Parse and attribute.**  :func:`read_trace_events` reads Kineto's
  format (gzipped or plain).  Device events are the ``X`` events of
  categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; a trace of
  a run with no GPU counts its ``cpu_op`` events as the device, so the
  machinery runs in CI as the reference's does on the CPU thunk runtime.
  :func:`attribute_trace` buckets device time into the families #1-#10,
  ``torch-op`` (every other kernel: the EM's LM products, gathers, the
  LBFGS vector work), ``memcpy/memset`` and ``other`` (one of the port's
  own kernels that could not be joined to a row).  A kernel joins its
  row through the ``gpu_user_annotation`` span on its stream, else
  through its ``correlation`` to the runtime launch inside a CPU
  ``sagecal::#`` span, else by its place in its stream's launch order
  (#4's gradient kernel follows its cotangent kernel; #2's does not).
  Each row's ``launches`` counts the wrapper calls it saw.  Total device
  time is the union of the tracks' busy intervals; ``idle_share`` is
  one less the union over the span from the first device event to the
  last, and the reference's dispatch-gap statistics are kept.  Given the
  run's span records (``obs/trace.py``, whose stamps are Kineto's
  Unix-epoch clock; an export's ``baseTimeNanoseconds`` is added back to
  its relative ``ts``), each dispatch gap's seconds go to the innermost
  program span open over it (:func:`idle_by_span`, a sweep: a span's
  self time): which host activity held the card idle.

``torch`` is imported inside the capture functions only: ``diag
roofline`` parses traces on any host.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import gzip
import heapq
import json
import os
import re
import socket
import time
from typing import Dict, Iterator, List, Optional, Tuple

_DEVPROF_ENV = "SAGECAL_DEVICE_PROFILE"
# "0": a capture on the card records device activity only (kernels,
# copies, the runtime's launches), not the host's operators: a tenth of
# a full-width tile's events
_CPU_OPS_ENV = "SAGECAL_DEVICE_PROFILE_CPU"
_FALSY = ("0", "false", "no", "off")

_active = None  # the running capture of this module (a dict)
_running = 0  # captures running in this process (this module's or a trace)
_last_trace: Optional[str] = None
_last_stats: dict = {}
_NULL = contextlib.nullcontext()


# ------------------------------------------------------------- capture


def begin_capture(log_dir: str, device=None,
                  cpu_ops: Optional[bool] = None) -> dict:
    """Start a ``torch.profiler`` session writing into ``log_dir``
    (shared with ``utils/profiling.py``'s trace).  ``device`` the run's
    (None: the card, as every entry point); a CUDA capture needs the
    CUDA activity (CUPTI) or raises.  On the card ``cpu_ops`` False (None:
    ``SAGECAL_DEVICE_PROFILE_CPU`` not "0") leaves the host's operators
    out."""
    global _running
    import torch

    from sagecal_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if cpu_ops is None:
        cpu_ops = os.environ.get(_CPU_OPS_ENV, "").strip().lower() \
            not in _FALSY
    cpu_ops = cpu_ops or dev.type != "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu_ops else []
    if dev.type == "cuda":
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError(
                "device profile: this torch cannot trace CUDA activity "
                "(no CUPTI); a profile without the card's kernels is "
                "refused")
        acts.append(cuda)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _running += 1
    return {"dir": log_dir, "prof": prof, "cuda": dev.type == "cuda"}


def end_capture(cap: dict, suffix: str = ".trace.json.gz") -> str:
    """Stop a session, write its trace (gzipped Chrome JSON) into its
    directory and return the path.  Raises RuntimeError when a CUDA
    capture holds no kernel event (the card was not seen)."""
    global _last_stats, _running
    prof = cap["prof"]
    _running -= 1
    prof.stop()
    stamp = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}"
    raw = os.path.join(cap["dir"], f"{stamp}.trace.json")
    t0 = time.perf_counter()
    prof.export_chrome_trace(raw)
    export_s = time.perf_counter() - t0
    with open(raw, "rb") as f:
        text = f.read()
    # counted in the text: parsing a full-width tile's trace takes
    # longer than exporting it
    events = len(re.findall(rb'"ph":\s*"', text))
    kernels = len(re.findall(rb'"cat":\s*"kernel"', text))
    path = raw
    if suffix.endswith(".gz"):
        path = raw + ".gz"
        with gzip.open(path, "wb", compresslevel=1) as dst:
            dst.write(text)
        os.remove(raw)
    del text
    _last_stats = {"path": path, "events": events,
                   "bytes": os.path.getsize(path), "export_s": export_s,
                   "gzip_s": time.perf_counter() - t0 - export_s,
                   "kernels": kernels}
    if cap["cuda"] and not _last_stats["kernels"]:
        raise RuntimeError(
            f"device profile {path}: no kernel event in a CUDA capture "
            f"(CUPTI did not record the card's activity)")
    return path


def capture_stats() -> dict:
    """The last written trace's path, events (metadata included), bytes,
    kernel events, and the seconds of torch's export and of the gzip."""
    return dict(_last_stats)


def _note(msg: str) -> None:
    from sagecal_tpu_torch.obs.flight import note_activity

    note_activity("device_profile", name=msg)


def start_device_profile(log_dir: Optional[str] = None,
                         device=None) -> Optional[str]:
    """Begin a capture (idempotent); the directory, or None when not
    requested (argument or ``SAGECAL_DEVICE_PROFILE``).  Another
    profiler session already running (``SAGECAL_PROFILE_DIR``) skips it,
    as the reference does: torch runs one session at a time."""
    global _active
    if _active is not None:
        return _active["dir"]
    log_dir = log_dir or os.environ.get(_DEVPROF_ENV)
    if not log_dir:
        return None
    from sagecal_tpu_torch.utils import profiling

    if profiling.active_trace() is not None:
        _note(f"device_profile skipped: {profiling.active_trace()} owns "
              f"the profiler")
        return None
    _active = begin_capture(log_dir, device)
    _note(f"device_profile started: {log_dir}")
    return log_dir


def stop_device_profile() -> Optional[str]:
    """Stop the capture this module started and return its trace's path
    (also kept for :func:`last_trace_path`)."""
    global _active, _last_trace
    if _active is None:
        return None
    cap, _active = _active, None
    path = end_capture(cap)
    _last_trace = path
    _note(f"device_profile trace: {path}")
    return path


@contextlib.contextmanager
def device_profile(log_dir: Optional[str] = None,
                   device=None) -> Iterator[Optional[str]]:
    """Capture scope: profiles the body when requested, a no-op
    otherwise; always stops a capture it started.  On the exception path
    the stop's own error (a blind capture) does not hide the body's."""
    d = start_device_profile(log_dir, device)
    try:
        yield d
    except BaseException:
        if d is not None and _active is not None:
            try:
                stop_device_profile()
            except RuntimeError:
                pass
        raise
    if d is not None:
        stop_device_profile()


def launch_annotation(row: int, name: str):
    """``record_function("sagecal::#<row> <name>")`` while a capture
    runs, else a shared no-op context."""
    if _running <= 0:
        return _NULL
    import torch

    return torch.profiler.record_function(f"sagecal::#{row} {name}")


def last_trace_path() -> Optional[str]:
    """Path of the newest trace this process captured, or None."""
    return _last_trace


def newest_trace_path(root: str) -> Optional[str]:
    """Newest ``*.trace.json[.gz]`` under ``root``."""
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits.extend(glob.glob(os.path.join(root, "**", pat),
                              recursive=True))
    if not hits:
        return None
    return max(hits, key=lambda p: (os.path.getmtime(p), p))


# -------------------------------------------------------- fleet arming


def _arm_path(out_dir: str, worker_id: str) -> str:
    return os.path.join(out_dir, f"device_profile_arm.{worker_id}.json")


def arm_fleet_profile(out_dir: str, worker_id: str,
                      profile_dir: Optional[str] = None) -> str:
    """Coordinator side: atomically drop the flag file that arms one
    worker of a live fleet for a single profiled cycle."""
    profile_dir = profile_dir or os.path.join(
        out_dir, f"devprof_{worker_id}")
    os.makedirs(out_dir, exist_ok=True)
    path = _arm_path(out_dir, worker_id)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"worker_id": worker_id, "profile_dir": profile_dir}, f)
    os.replace(tmp, path)
    return path


def check_fleet_arm(out_dir: str, worker_id: str) -> Optional[dict]:
    """Worker side: the arm request for this worker, or None (a corrupt
    or partial flag reads as un-armed)."""
    path = _arm_path(out_dir, worker_id)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            req = json.load(f)
    except (OSError, ValueError):
        return None
    req.setdefault("profile_dir",
                   os.path.join(out_dir, f"devprof_{worker_id}"))
    req["_path"] = path
    return req


def complete_fleet_arm(req: dict, trace_path: Optional[str]) -> str:
    """Worker side: retire the arm flag to ``.done`` carrying the trace
    path, so the worker never profiles again."""
    path = req["_path"]
    done = path + ".done"
    tmp = done + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"worker_id": req.get("worker_id"),
                   "trace_path": trace_path}, f)
    os.replace(tmp, done)
    try:
        os.remove(path)
    except OSError:
        pass
    return done


# --------------------------------------------------------------- parse


def _read_doc(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _tracks(events: List[dict]) -> Dict[str, str]:
    procs: Dict[str, str] = {}
    threads: Dict[str, str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            procs[str(e.get("pid"))] = str(args.get("name", ""))
        elif e.get("name") == "thread_name":
            threads[f"{e.get('pid')}/{e.get('tid')}"] = \
                str(args.get("name", ""))
    return {key: f"{procs.get(key.split('/', 1)[0], '')}/{tname}"
            for key, tname in threads.items()}


def read_trace_events(path: str) -> Tuple[List[dict], Dict[str, str]]:
    """``(trace_events, track_names)`` of a Chrome/Kineto trace (gz or
    plain JSON); track_names maps ``"pid/tid"`` to ``"process
    name/thread name"``."""
    events = _read_doc(path).get("traceEvents", [])
    return events, _tracks(events)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GPU_HINT_CATS = ("cuda_runtime", "cuda_driver", "gpu_user_annotation")


def device_op_events(events: List[dict],
                     gpu: Optional[bool] = None) -> List[dict]:
    """The complete ``X`` events of device execution: ``kernel``,
    ``gpu_memcpy`` and ``gpu_memset``.  A trace of a run without a GPU
    (``gpu`` False, or None and no runtime or annotation event on a GPU
    track) gives its ``cpu_op`` events instead."""
    out = [e for e in events if e.get("ph") == "X" and e.get("dur")
           is not None and e.get("cat") in _DEVICE_CATS]
    if out:
        return out
    if gpu is None:
        gpu = any(e.get("cat") in _GPU_HINT_CATS for e in events)
    if gpu:
        return []
    return [e for e in events if e.get("ph") == "X"
            and e.get("dur") is not None and e.get("cat") == "cpu_op"]


# ------------------------------------------------------- classification

KERNEL_FAMILIES = tuple(f"#{r}" for r in range(1, 11)) + (
    "torch-op", "memcpy/memset", "other")

# the port's own kernels (csrc/*.cu) by the name Kineto prints
_OWN_KERNEL_RE = re.compile(
    r"(fused_cost_(fwd|cot|grad)_kernel|fused_predict_fwd_kernel"
    r"|sum_partials_kernel|kbisect_(c|c_sum|b|a_reduce|a_gather|f_reduce"
    r"|f_gather)_kernel)\b")
_ANNOT_RE = re.compile(r"^sagecal::#(\d+)\b")


@functools.lru_cache(maxsize=4096)
def own_kernel(name: str) -> Optional[str]:
    """The port's kernel function a device event ran (e.g.
    ``fused_cost_grad_kernel``), or None for any other."""
    m = _OWN_KERNEL_RE.search(name or "")
    return m.group(1) if m else None


@functools.lru_cache(maxsize=4096)
def _batched(name: str) -> bool:
    return bool(re.search(r"_kernel<[^,>]*, true>", name or ""))


def classify_kernel(name: str, cat: str = "kernel",
                    row: Optional[int] = None) -> str:
    """The family of one device event: its row ``#n`` when joined to
    one, ``memcpy/memset`` for copies and fills, ``other`` for one of
    the port's kernels left unjoined, ``torch-op`` for every other kernel
    (and every ``cpu_op`` of a run without a GPU)."""
    if row is not None:
        return f"#{row}"
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy/memset"
    if own_kernel(name):
        return "other"
    return "torch-op"


def _sequence_rows(ops: List[dict]) -> Dict[int, Tuple[int, bool]]:
    """Rows by launch order on each stream (the join of last resort):
    index -> (row, leading kernel of its launch)."""
    out: Dict[int, Tuple[int, bool]] = {}
    prev: Dict[str, Tuple[str, int]] = {}
    order = sorted(range(len(ops)), key=lambda i: float(ops[i]["ts"]))
    for i in order:
        e = ops[i]
        k = own_kernel(e.get("name", ""))
        if k is None:
            continue
        key = f"{e.get('pid')}/{e.get('tid')}"
        last, last_row = prev.get(key, (None, 0))
        b = _batched(e["name"])
        if k == "fused_predict_fwd_kernel":
            row, lead = 1, True
        elif k == "fused_cost_fwd_kernel":
            row, lead = (5 if b else 3), True
        elif k == "fused_cost_cot_kernel":
            row, lead = (6 if b else 4), True
        elif k == "fused_cost_grad_kernel":
            if b:
                row, lead = 6, last != "fused_cost_cot_kernel"
            elif last == "fused_cost_cot_kernel":
                row, lead = 4, False
            else:
                row, lead = 2, True
        elif k == "sum_partials_kernel":
            row, lead = (last_row or 2), last != "fused_cost_grad_kernel"
        elif k.startswith("kbisect_c"):
            row, lead = 7, k == "kbisect_c_kernel"
        elif k == "kbisect_b_kernel":
            row, lead = 8, True
        elif k.startswith("kbisect_a"):
            row, lead = 9, not (k == "kbisect_a_gather_kernel"
                                and last == "kbisect_a_reduce_kernel")
        else:
            row, lead = 10, not (k == "kbisect_f_gather_kernel"
                                 and last == "kbisect_f_reduce_kernel")
        out[i] = (row, lead)
        prev[key] = (k, row)
    return out


def _annotation_rows(events: List[dict], ops: List[dict],
                     pattern: re.Pattern = _ANNOT_RE
                     ) -> Dict[int, Tuple[int, tuple]]:
    """Rows through the ``sagecal::#n`` annotations (or any ``pattern``
    whose first group is an integer): index -> (the number, the
    annotation span's key), from the GPU-side ``gpu_user_annotation``
    spans on the kernel's stream, else through the kernel's
    ``correlation`` to its runtime launch inside a CPU span."""
    spans_gpu: Dict[str, list] = {}
    spans_cpu: Dict[str, list] = {}
    launch_at: Dict[int, Tuple[str, float]] = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("gpu_user_annotation", "user_annotation") \
                or e.get("ph") != "X":
            continue
        m = pattern.match(e.get("name", ""))
        if not m:
            continue
        key = f"{e.get('pid')}/{e.get('tid')}"
        ts, dur = float(e["ts"]), float(e.get("dur") or 0.0)
        span = (ts, ts + dur, int(m.group(1)), (cat, key, ts))
        (spans_gpu if cat == "gpu_user_annotation"
         else spans_cpu).setdefault(key, []).append(span)
    if not (spans_gpu or spans_cpu):  # a capture of the card's activity
        return {}
    if spans_cpu:
        for e in events:
            if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_at[int(corr)] = (
                        f"{e.get('pid')}/{e.get('tid')}", float(e["ts"]))
    out: Dict[int, Tuple[int, tuple]] = {}

    def inside(spans, t0, t1):
        best = None
        for s0, s1, row, key in spans:
            if s0 <= t0 and t1 <= s1 and (best is None
                                          or s1 - s0 < best[1] - best[0]):
                best = (s0, s1, row, key)
        return best

    for i, e in enumerate(ops):
        if own_kernel(e.get("name", "")) is None:
            continue
        key = f"{e.get('pid')}/{e.get('tid')}"
        ts = float(e["ts"])
        hit = inside(spans_gpu.get(key, ()), ts, ts + float(e["dur"]))
        if hit is None:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None and int(corr) in launch_at:
                tkey, lts = launch_at[int(corr)]
                hit = inside(spans_cpu.get(tkey, ()), lts, lts)
        if hit is not None:
            out[i] = (hit[2], hit[3])
    return out


# --------------------------------------------------------- attribution


def launch_record(e: dict) -> dict:
    """One of the port's kernel events: {name, full, batched,
    shared_memory, registers, grid, block}."""
    name = str(e.get("name", ""))
    args = e.get("args") or {}
    return {"name": own_kernel(name) or name, "full": name,
            "batched": _batched(name),
            "shared_memory": args.get("shared memory"),
            "registers": args.get("registers per thread"),
            "grid": args.get("grid"), "block": args.get("block")}


def _self_durations(track_events: List[Tuple[float, float, int]]
                    ) -> Dict[int, float]:
    """Exclusive duration per event on one track (a nested ``cpu_op`` is
    billed to itself, not to its parent too)."""
    out: Dict[int, float] = {}
    stack: List[Tuple[float, int]] = []
    for ts, dur, idx in sorted(track_events):
        end = ts + dur
        out[idx] = dur
        while stack and stack[-1][0] <= ts:
            stack.pop()
        if stack:
            parent_end, parent = stack[-1]
            out[parent] -= min(end, parent_end) - ts
        stack.append((end, idx))
    return out


def _union_us(ivals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals (us)."""
    if not ivals:
        return 0.0
    ivals = sorted(ivals)
    total = 0.0
    cur_s, cur_e = ivals[0]
    for s, e in ivals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _merged_windows(ivals: List[Tuple[float, float]],
                    gap_threshold_us: float) -> List[Tuple[float, float]]:
    """Busy windows: intervals merged across gaps below the threshold."""
    if not ivals:
        return []
    ivals = sorted(ivals)
    out = [list(ivals[0])]
    for s, e in ivals[1:]:
        if s - out[-1][1] <= gap_threshold_us:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_span(gaps_us: List[Tuple[float, float]],
                 spans: List[dict]) -> Dict[str, float]:
    """Seconds of the idle intervals ``gaps_us`` ((start, end), Unix-epoch
    us) under each program span name, each instant billed to the
    innermost span open over it (the latest started), ``(none)`` where
    none is.  ``spans``: span records (``ts`` and ``dur`` in seconds)."""
    ivals = sorted((float(s.get("ts", 0.0)) * 1e6,
                    (float(s.get("ts", 0.0)) + max(float(s.get("dur", 0.0)),
                                                   0.0)) * 1e6,
                    str(s.get("name", "?"))) for s in spans)
    cuts = sorted({t for g in gaps_us for t in g}
                  | {t for s, e, _ in ivals for t in (s, e)})
    out: Dict[str, float] = {}
    open_: Dict[int, Tuple[float, str]] = {}  # index -> (start, name)
    ends: List[Tuple[float, int]] = []  # heap of (end, index)
    nxt = 0
    gaps = sorted(gaps_us)
    gi = 0
    for a, b in zip(cuts, cuts[1:]):
        while nxt < len(ivals) and ivals[nxt][0] <= a:
            s, e, name = ivals[nxt]
            open_[nxt] = (s, name)
            heapq.heappush(ends, (e, nxt))
            nxt += 1
        while ends and ends[0][0] <= a:
            open_.pop(heapq.heappop(ends)[1], None)
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi >= len(gaps) or gaps[gi][0] > a:
            continue
        name = max(open_.values())[1] if open_ else "(none)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def attribute_trace(path: str, gap_threshold_us: float = 1000.0,
                    program_spans: Optional[List[dict]] = None) -> dict:
    """Attribute one trace's device time to the families (module doc).

    Returns ``{"trace_path", "gpu", "n_op_events", "total_device_us",
    "span_us", "families": {fam: {time_us, events, launches,
    top_ops}}, "launches": [{name, full, row, dur_us, batched,
    shared_memory, registers, grid, block}] (the port's kernels),
    "dispatch":
    {n_windows, n_gaps, gap_total_us, gap_mean_us, gap_p50_us,
    gap_max_us, amortization, idle_share}, "join": {annotation,
    sequence}}``.  ``total_device_us`` is the union of each track's busy
    intervals summed over tracks; family times are self durations, so
    they sum to it; ``coverage`` is the share of it in families other
    than ``other``.  With the run's ``program_spans`` (``obs/trace.py``'s
    records), ``dispatch`` adds ``gaps_by_span``: the gaps' seconds by
    the innermost program span open over them (:func:`idle_by_span`)."""
    doc = _read_doc(path)
    events = doc.get("traceEvents", [])
    base_us = float(doc.get("baseTimeNanoseconds") or 0) * 1e-3
    gpu = bool(doc.get("deviceProperties")) or any(
        e.get("cat") in _DEVICE_CATS + _GPU_HINT_CATS for e in events)
    ops = device_op_events(events, gpu)
    annot = _annotation_rows(events, ops) if gpu else {}
    seq = _sequence_rows(ops) if gpu else {}

    per_track: Dict[str, List[Tuple[float, float]]] = {}
    track_idx: Dict[str, List[Tuple[float, float, int]]] = {}
    all_ivals: List[Tuple[float, float]] = []
    for i, e in enumerate(ops):
        dur, ts = float(e.get("dur", 0.0)), float(e.get("ts", 0.0))
        key = f"{e.get('pid')}/{e.get('tid')}"
        per_track.setdefault(key, []).append((ts, ts + dur))
        track_idx.setdefault(key, []).append((ts, dur, i))
        all_ivals.append((ts, ts + dur))
    self_us: Dict[int, float] = {}
    for tevs in track_idx.values():
        self_us.update(_self_durations(tevs))

    families: Dict[str, dict] = {}
    op_times: Dict[str, Dict[str, float]] = {}
    spans: Dict[str, set] = {}
    launches: List[dict] = []
    joined = {"annotation": 0, "sequence": 0}
    for i, e in enumerate(ops):
        name = str(e.get("name", ""))
        row, span = None, None
        if i in annot:
            row, span = annot[i]
            joined["annotation"] += 1
        elif i in seq:
            row, lead = seq[i]
            joined["sequence"] += 1
            if lead:
                span = ("sequence", i)
        fam = classify_kernel(name, e.get("cat", ""), row)
        dur = max(self_us.get(i, 0.0), 0.0)
        f = families.setdefault(fam, {"time_us": 0.0, "events": 0,
                                      "launches": 0})
        f["time_us"] += dur
        f["events"] += 1
        if span is not None:
            spans.setdefault(fam, set()).add(span)
        short = own_kernel(name) or name
        op_times.setdefault(fam, {})
        op_times[fam][short] = op_times[fam].get(short, 0.0) + dur
        if own_kernel(name):
            launches.append(dict(launch_record(e), row=row, dur_us=dur))
    total_us = sum(_union_us(iv) for iv in per_track.values())
    for fam, f in families.items():
        f["launches"] = len(spans.get(fam, ())) if fam.startswith("#") \
            else f["events"]
        tops = sorted(op_times.get(fam, {}).items(), key=lambda kv: -kv[1])
        f["top_ops"] = [{"op": k, "time_us": round(v, 1)}
                        for k, v in tops[:5]]
        f["time_us"] = round(f["time_us"], 3)

    dispatch: dict = {}
    span_us = 0.0
    if all_ivals:
        span_us = max(e for _, e in all_ivals) - min(s for s, _ in all_ivals)
        windows = _merged_windows(all_ivals, gap_threshold_us)
        gaps = sorted(g for g in (windows[i + 1][0] - windows[i][1]
                                  for i in range(len(windows) - 1)) if g > 0)
        busy = sum(e - s for s, e in windows)
        union_all = _union_us(all_ivals)
        dispatch = {
            "n_windows": len(windows),
            "n_gaps": len(gaps),
            "gap_total_us": round(sum(gaps), 1),
            "gap_mean_us": round(sum(gaps) / len(gaps), 1) if gaps else 0.0,
            "gap_p50_us": round(gaps[len(gaps) // 2], 1) if gaps else 0.0,
            "gap_max_us": round(max(gaps), 1) if gaps else 0.0,
            "amortization": round(busy / span_us, 4) if span_us > 0 else 1.0,
            "idle_share": (1.0 - union_all / span_us) if span_us > 0
            else 0.0,
        }
        if program_spans is not None:
            gap_ivals = [(windows[i][1] + base_us, windows[i + 1][0] + base_us)
                         for i in range(len(windows) - 1)
                         if windows[i + 1][0] > windows[i][1]]
            dispatch["gaps_by_span"] = {
                k: round(v, 6) for k, v in sorted(
                    idle_by_span(gap_ivals, program_spans).items(),
                    key=lambda kv: -kv[1])}
    attributed = sum(f["time_us"] for k, f in families.items()
                     if k != "other")
    return {
        "trace_path": path,
        "gpu": gpu,
        "n_op_events": len(ops),
        "total_device_us": round(total_us, 3),
        "span_us": round(span_us, 3),
        "coverage": attributed / total_us if total_us else 0.0,
        "families": families,
        "launches": launches,
        "dispatch": dispatch,
        "join": joined,
    }


# --------------------------------------------------------- ledger join


def ledger_from_events(events_path: str) -> Dict[str, dict]:
    """Offline ledger: the ``kernel_work`` events of a JSONL event log,
    summed per row (``#n``): {name, launches, bytes, flops, gathers,
    bound_ms} (bytes, flops and bound summed over the launches)."""
    from sagecal_tpu_torch.obs.perf import fold_kernel_work

    rows: List[dict] = []
    try:
        with open(events_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("type", ev.get("event")) == "kernel_work":
                    rows.append(ev)
    except OSError:
        pass
    return fold_kernel_work(rows)
