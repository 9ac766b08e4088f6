"""Per-device peaks, arithmetic intensity and the per-row roofline of a
device profile (counterpart of ``sagecal_tpu/obs/roofline.py``).

- :data:`PEAK_TABLE` carries the reference's rows (``tpu v5e``, the
  nominal ``cpu`` row that keeps the machinery running in CI) and the
  H100 row the reference's stub comment names, keyed by what
  ``torch.cuda.get_device_name()`` prints ("NVIDIA H100 80GB HBM3").
  Its values are the data-sheet peaks of the H100 SXM at 700 W that
  ``kernels/work.py`` keeps for every bound of the port (HBM bytes a
  second, the f32 non-tensor FLOP rate, the on-chip gather rate),
  imported, not restated.  An unknown kind resolves to None and is
  reported as unknown, never given a wrong peak.
- :func:`launch_bound` is the roofline of one launch (bytes, flops and
  gathers): ``kernels/work.py::roofline``, the one function behind both
  the kernel table's bounds and ``diag roofline``'s.
- :func:`build_report` joins a device profile's per-row attribution
  (``obs/devprof.py::attribute_trace``) with the per-launch work ledger
  (``obs/perf.py``'s ``kernel_work`` events) into one line per row:
  device ms, launches, ms a launch, the bound a launch, bound over ms
  and the share of device time; then the ``torch-op`` family's share
  and the device's idle share.  :func:`set_kernel_gauges` exports the
  same numbers as registry gauges.

Stdlib only apart from the package's own stdlib modules.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sagecal_tpu_torch.kernels.work import (
    F32_FLOPS_PER_S, GATHER_WORDS_PER_S, HBM_BYTES_PER_S, roofline,
)
from sagecal_tpu_torch.obs.registry import get_registry

# ------------------------------------------------------------ peak table

#: Device peaks: ``peak_flops`` per chip FLOP/s by compute dtype,
#: ``hbm_gbps`` the memory bandwidth; ``nominal`` marks placeholders.
PEAK_TABLE: Dict[str, dict] = {
    "tpu v5e": {
        "label": "TPU v5e",
        "peak_flops": {"bf16": 197e12, "f32": 98.5e12},
        "hbm_gbps": 819.0,
    },
    "cpu": {
        "label": "host CPU (nominal single-core)",
        # NOMINAL: order-of-magnitude single-core figures that exercise
        # the machinery in CI; never hardware truth
        "peak_flops": {"f32": 1e10, "bf16": 1e10, "f64": 5e9},
        "hbm_gbps": 10.0,
        "nominal": True,
    },
    "nvidia h100 80gb hbm3": {
        "label": "H100 SXM (data-sheet peaks at 700 W)",
        # the port's kernels compute in exact f32 without tensor cores:
        # the f32 non-tensor rate is the only compute peak
        "peak_flops": {"f32": F32_FLOPS_PER_S},
        "hbm_gbps": HBM_BYTES_PER_S / 1e9,
        "gather_words_per_s": GATHER_WORDS_PER_S,
    },
}

#: device_kind strings observed in the wild -> canonical table key.
KIND_ALIASES: Dict[str, str] = {
    "tpu v5 lite": "tpu v5e",
    "tpu v5litepod": "tpu v5e",
    "cpu (unknown)": "cpu",
    "unknown": "cpu",
}


def normalize_kind(device_kind: Optional[str]) -> str:
    return (device_kind or "").strip().lower()


def lookup_peaks(device_kind: Optional[str]) -> Optional[dict]:
    """The PEAK_TABLE entry for a device kind, or None when unknown."""
    k = normalize_kind(device_kind)
    if not k:
        return None
    k = KIND_ALIASES.get(k, k)
    if k in PEAK_TABLE:
        return PEAK_TABLE[k]
    for key in PEAK_TABLE:
        if key in k:
            return PEAK_TABLE[key]
    return None


def peak_flops(device_kind: Optional[str],
               dtype: str = "f32") -> Optional[float]:
    peaks = lookup_peaks(device_kind)
    if peaks is None:
        return None
    fl = peaks["peak_flops"]
    return float(fl.get(dtype) or fl.get("f32") or 0.0) or None


def peak_hbm_gbps(device_kind: Optional[str]) -> Optional[float]:
    peaks = lookup_peaks(device_kind)
    return float(peaks["hbm_gbps"]) if peaks else None


def ridge_intensity(peaks: dict, dtype: str = "f32") -> float:
    """FLOP/byte at the roofline ridge."""
    fl = peaks["peak_flops"]
    f = float(fl.get(dtype) or fl.get("f32") or 0.0)
    bw = float(peaks["hbm_gbps"]) * 1e9
    return f / bw if bw else 0.0


def mfu(flops_per_sec: Optional[float], device_kind: Optional[str],
        dtype: str = "f32") -> Optional[float]:
    """Measured-vs-peak FLOP utilization, None when either is unknown."""
    pk = peak_flops(device_kind, dtype)
    if not flops_per_sec or not pk:
        return None
    return float(flops_per_sec) / pk


def bw_util(bytes_per_sec: Optional[float],
            device_kind: Optional[str]) -> Optional[float]:
    bw = peak_hbm_gbps(device_kind)
    if not bytes_per_sec or not bw:
        return None
    return float(bytes_per_sec) / (bw * 1e9)


def launch_bound(nbytes: int, flops: int, gathers: int = 0) -> dict:
    """The roofline of one launch on the H100: the kernel table's bound
    (``kernels/work.py::roofline``)."""
    return roofline(nbytes, flops, gathers)


# ---------------------------------------------------- per-row report


def build_report(attribution: dict, ledger: Optional[Dict[str, dict]],
                 device_kind: Optional[str], dtype: str = "f32") -> dict:
    """Join a device profile's attribution with the per-launch work
    ledger (module doc).  Returns ``{"device_kind", "peaks", "dtype",
    "rows", "total_device_us", "attributed_us", "coverage",
    "torch_op_share", "idle_share", "dispatch"}``; a row is ``{"family",
    "device_us", "launches", "ms_per_launch", "bound_ms_per_launch",
    "bound_over_ms", "share", "events", "mfu", "bw_util", "top_ops"}``,
    rows #1-#10 first, then the families by device time."""
    peaks = lookup_peaks(device_kind)
    fams = attribution.get("families", {})
    total_us = float(attribution.get("total_device_us", 0.0))
    ledger = ledger or {}
    rows: List[dict] = []
    for fam, f in fams.items():
        t_us = float(f.get("time_us", 0.0))
        n = int(f.get("launches") or 0)
        ms_launch = (t_us / 1e3 / n) if n else None
        w = ledger.get(fam) if fam.startswith("#") else None
        bound = (w["bound_ms"] / w["launches"]
                 if w and w.get("launches") else None)
        t_s = t_us / 1e6
        fps = (w["flops"] / w["launches"] * n / t_s
               if w and n and t_s > 0 else None)
        bps = (w["bytes"] / w["launches"] * n / t_s
               if w and n and t_s > 0 else None)
        rows.append({
            "family": fam,
            "device_us": round(t_us, 1),
            "events": int(f.get("events", 0)),
            "launches": n,
            "ms_per_launch": ms_launch,
            "bound_ms_per_launch": bound,
            "bound_over_ms": (bound / ms_launch
                              if bound and ms_launch else None),
            "share": round(t_us / total_us, 4) if total_us else None,
            "mfu": mfu(fps, device_kind, dtype),
            "bw_util": bw_util(bps, device_kind),
            "top_ops": f.get("top_ops", [])[:3],
        })
    rows.sort(key=lambda r: (0, int(r["family"][1:]))
              if r["family"].startswith("#") else (1, -r["device_us"]))
    attributed = sum(r["device_us"] for r in rows if r["family"] != "other")
    dispatch = attribution.get("dispatch") or {}
    torch_op = fams.get("torch-op", {}).get("time_us", 0.0)
    return {
        "device_kind": device_kind,
        "peaks": peaks,
        "dtype": dtype,
        "rows": rows,
        "total_device_us": total_us,
        "attributed_us": attributed,
        "coverage": attribution.get("coverage", 0.0),
        "torch_op_share": torch_op / total_us if total_us else 0.0,
        "idle_share": dispatch.get("idle_share"),
        "dispatch": dispatch,
    }


def set_kernel_gauges(report: dict) -> None:
    """Per-family device seconds, and per-row ms a launch and bound
    over ms, as registry gauges."""
    reg = get_registry()
    for r in report.get("rows", []):
        fam = r["family"]
        reg.gauge_set("kernel_device_seconds", r["device_us"] / 1e6,
                      help="measured device seconds per kernel family "
                           "(device-profile attribution)", family=fam)
        if r.get("bound_over_ms") is not None:
            reg.gauge_set("kernel_bound_over_time", float(r["bound_over_ms"]),
                          help="a launch's roofline bound over its measured "
                               "device time, per kernel row", family=fam)
        if r.get("bw_util") is not None:
            reg.gauge_set("kernel_bw_util", float(r["bw_util"]),
                          help="measured-vs-peak HBM bandwidth utilization "
                               "per kernel row", family=fam)


def _fmt(v, fmt: str = "{:.4f}") -> str:
    return "-" if v is None else fmt.format(v)


def format_report(report: dict) -> str:
    """Human rendering for ``diag roofline``."""
    kind = report.get("device_kind") or "?"
    peaks = report.get("peaks")
    lines: List[str] = []
    if peaks is None:
        lines.append(
            f"roofline: UNKNOWN device kind {kind!r}: no PEAK_TABLE entry, "
            f"utilizations omitted (add one in obs/roofline.py rather than "
            f"trust a wrong peak)")
    else:
        dtype = report.get("dtype", "f32")
        fl = peaks["peak_flops"]
        pk = fl.get(dtype, fl.get("f32"))
        tag = " [NOMINAL CI entry, not hardware truth]" \
            if peaks.get("nominal") else ""
        lines.append(
            f"roofline: {peaks['label']} ({kind}): peak {pk / 1e12:.3g} "
            f"TFLOP/s {dtype}, {peaks['hbm_gbps']:.0f} GB/s HBM, ridge "
            f"{ridge_intensity(peaks, dtype):.1f} FLOP/byte{tag}")
    tot = report.get("total_device_us", 0.0)
    lines.append(f"device time: {tot / 1e3:.3f} ms across "
                 f"{len(report.get('rows', []))} families, "
                 f"{report.get('coverage', 0.0) * 100:.1f}% attributed")
    lines.append(f"{'family':<15}{'device ms':>11}{'launches':>9}"
                 f"{'ms/launch':>11}{'bound ms':>10}{'bound/ms':>9}"
                 f"{'share':>8}")
    for r in report.get("rows", []):
        lines.append(
            f"{r['family']:<15}{r['device_us'] / 1e3:>11.3f}"
            f"{r['launches']:>9}{_fmt(r['ms_per_launch']):>11}"
            f"{_fmt(r['bound_ms_per_launch']):>10}"
            f"{_fmt(r['bound_over_ms'], '{:.1%}'):>9}"
            f"{_fmt(r['share'], '{:.2%}'):>8}")
    lines.append(f"torch-op share of device time: "
                 f"{report.get('torch_op_share', 0.0) * 100:.2f}%")
    d = report.get("dispatch") or {}
    if d:
        lines.append(
            f"device idle share: {d.get('idle_share', 0.0) * 100:.2f}% of "
            f"the span from the first device event to the last")
        lines.append(
            f"dispatch gaps: {d.get('n_gaps', 0)} gaps "
            f"{d.get('gap_total_us', 0.0) / 1e3:.1f} ms total (mean "
            f"{d.get('gap_mean_us', 0.0) / 1e3:.1f} ms, max "
            f"{d.get('gap_max_us', 0.0) / 1e3:.1f} ms) across "
            f"{d.get('n_windows', 0)} device windows; busy fraction "
            f"{d.get('amortization', 0.0) * 100:.1f}%")
        by = d.get("gaps_by_span")
        if by is not None:
            lines.append("dispatch gaps by the innermost program span "
                         "open over them (s):")
            lines.extend(f"  {name:<32}{s:>12.6f}" for name, s in by.items())
    return "\n".join(lines)
