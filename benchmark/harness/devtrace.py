"""One app run under ``torch.profiler`` (the card's activity only), and
its reduction to what the per-layer metric readers read.

Layers are marked from the benchmark's side: :class:`Probe` wraps the
app's calls into a layer (its module-level names in
``apps/fullbatch.py``) and, while a capture runs, launches an empty
marker kernel (``torch.cuda._sleep(0)``, named ``spin_kernel``) on the
current stream before and after each call.  Every device operation on
the markers' stream between a layer's two markers, in that stream's
order, is that layer's; operations on other streams belong to no layer.
The host clock times each call as a span, profiled or not.

The reduction (:func:`reduce_trace`) works on plain tuples (name,
start us, duration us, stream) of the device's operations, so a test
can hand it a made-up trace: the union of busy intervals, each layer's
busy time, the operations that took most time, and the idle gaps
between operations, each labelled by what the host was doing: the layer
of the operation that ends the gap, or ``app`` where that operation
opens a layer or belongs to none (the host was in the app's own code
between layers).  A trace whose markers are not all on one stream, or
not as many as the host launched, raises: the layers' times would be
wrong, and a traced run then ends with no result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

MARKER = "spin_kernel"


@dataclasses.dataclass
class Reduction:
    busy_s: float
    window_s: float
    layer_busy_s: Dict[str, float]
    layer_calls: Dict[str, int]
    op_seconds: Dict[str, float]  # device seconds by operation name
    op_counts: Dict[str, int]
    gaps: List[Tuple[str, float]]  # (label, seconds), in time order
    n_events: int
    markers: Tuple[int, int]  # (marker kernels seen, marks launched)


def short_name(name: str) -> str:
    """An operation's name without its argument list, return type and
    anonymous namespaces (the program's kernels sit in one)."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if s.startswith("void "):
        s = s[5:]
    return s[:160]


def _union_s(ivals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(ivals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def reduce_trace(events: list, marks: list, window_s: float) -> Reduction:
    """``events``: (name, start_us, dur_us, stream) of every device
    operation; ``marks``: the host's marker launches in order, (layer,
    "begin" or "end").  The i-th marker kernel in its stream's order is
    the i-th mark (module doc)."""
    streams = {e[3] for e in events if MARKER in e[0]}
    if len(streams) > 1:
        raise ValueError(f"layer markers on {len(streams)} streams")
    mstream = next(iter(streams), None)
    evs = sorted(events, key=lambda e: e[1])
    layer_iv: Dict[str, list] = {}
    calls: Dict[str, int] = {}
    op_s: Dict[str, float] = {}
    op_n: Dict[str, int] = {}
    tagged = []  # (start, end, layer or None, opens_layer)
    stack: List[str] = []
    mi = 0
    opening = False
    for name, start, dur, stream in evs:
        if MARKER in name:
            if mi < len(marks):
                layer, kind = marks[mi]
                if kind == "begin":
                    stack.append(layer)
                    calls[layer] = calls.get(layer, 0) + 1
                    opening = True
                elif stack:
                    stack.pop()
            mi += 1
            continue
        key = short_name(name)
        op_s[key] = op_s.get(key, 0.0) + dur * 1e-6
        op_n[key] = op_n.get(key, 0) + 1
        if stream != mstream:
            tagged.append((start, start + dur, None, False))
            continue
        layer = stack[-1] if stack else None
        tagged.append((start, start + dur, layer, opening))
        opening = False
        if layer is not None:
            layer_iv.setdefault(layer, []).append((start, start + dur))
    if mi != len(marks):
        raise ValueError(f"{mi} layer markers in the trace, {len(marks)} "
                         f"launched")
    gaps = []
    end = None
    for s, e, layer, opens in tagged:
        if end is not None and s > end:
            label = "app" if (layer is None or opens) else layer
            gaps.append((label, (s - end) * 1e-6))
        end = e if end is None else max(end, e)
    return Reduction(
        busy_s=_union_s([(s, e) for s, e, _, _ in tagged]),
        window_s=window_s,
        layer_busy_s={k: _union_s(v) for k, v in layer_iv.items()},
        layer_calls=calls, op_seconds=op_s, op_counts=op_n, gaps=gaps,
        n_events=len(tagged), markers=(mi, len(marks)))


def breakdown(red: Reduction) -> dict:
    """The result line's ``breakdown``: the ten operations of most device
    time, and the idle time by what the host was doing (each label's
    summed gaps and, as ``<label>.longest``, its longest gap), the ten
    largest."""
    ops = sorted(red.op_seconds.items(), key=lambda kv: -kv[1])[:10]
    by: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    for label, s in red.gaps:
        by[label] = by.get(label, 0.0) + s
        longest[label] = max(longest.get(label, 0.0), s)
    idle = [(k, v) for k, v in by.items()]
    idle += [(f"{k}.longest", v) for k, v in longest.items()]
    idle.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle[:10]]}


class Probe:
    """Spans (and, while ``marking``, device markers) around the app's
    calls into its layers: ``install(module, {name: layer})`` replaces
    each named function of ``module`` by a timed wrapper, ``restore()``
    puts them back."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.marks: List[Tuple[str, str]] = []
        self.marking = False
        self._saved = []

    def _mark(self, layer: str, kind: str) -> None:
        if self.marking:
            import torch

            torch.cuda._sleep(0)
            self.marks.append((layer, kind))

    def install(self, module, names: Dict[str, str]) -> None:
        for fname, layer in names.items():
            real = getattr(module, fname)
            self._saved.append((module, fname, real))

            def wrapped(*a, _real=real, _layer=layer, **kw):
                self._mark(_layer, "begin")
                t = time.perf_counter()
                try:
                    return _real(*a, **kw)
                finally:
                    self.spans.setdefault(_layer, []).append(
                        time.perf_counter() - t)
                    self._mark(_layer, "end")

            setattr(module, fname, wrapped)

    def restore(self) -> None:
        for module, fname, real in reversed(self._saved):
            setattr(module, fname, real)
        self._saved.clear()


def device_events(prof) -> list:
    """(name, start_us, dur_us, stream) of every device operation of a
    finished ``torch.profiler.profile``, from the profiler's own records
    (Kineto's resource id of a device operation is its stream)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), start, dur, e.device_resource_id()))
    return out


def profiled(fn: Callable, probe: Probe):
    """Run ``fn()`` under a device-only capture with the probe's markers
    on; returns (fn's result, host seconds of the run, device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    probe.marks.clear()
    probe.marking = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            seconds = time.perf_counter() - t
            probe.marking = False
    return out, seconds, device_events(prof)
