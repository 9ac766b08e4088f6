"""Host side of the quality watchdog (counterpart of
``sagecal_tpu/obs/quality.py``): reports, verdicts, heatmaps.

The device half (:mod:`sagecal_tpu_torch.ops.quality`) returns
fixed-shape :class:`~sagecal_tpu_torch.ops.quality.SolveQuality` bundles
of tensors from inside the solves.  Here, after the solve returns:

- :func:`quality_to_host`: tensors -> numpy arrays keyed by field name;
- :func:`assess_quality`: the verdict ``"ok"`` / ``"degraded"`` /
  ``"diverged"`` with its reasons (divergence: non-finite gains or
  chi^2; degradation: a station's chi^2 a large outlier, or the robust
  weights flattening most of the data);
- :func:`check_and_emit`: the app hook (``solve_quality`` event,
  registry gauges, escalation events);
- :func:`assess_consensus`: the ADMM watchdog's verdict on per-band
  residual trajectories;
- :func:`abort_if_diverged`: the ``abort_on_divergence`` exit;
- the PPM heatmap writers.

The hierarchical-predict and ``diag quality`` parts of the reference
belong to later slices (ROADMAP.md, A8 and A11).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sagecal_tpu_torch.obs.registry import get_registry
from sagecal_tpu_torch.utils.ppm import write_ppm

# A station whose chi^2 exceeds this multiple of the median (over
# stations with data) is flagged as an outlier — the classic "one bad
# station" signature the reference finds by eyeballing residual images.
CHI2_OUTLIER_RATIO = 25.0
# Degradation threshold on the effectively down-weighted fraction: when
# the robust weights have flattened more than this share of the
# unflagged data, the Gaussian interpretation of chi^2 is gone.
DOWNWEIGHT_WARN_FRAC = 0.5
# A band whose final primal residual exceeds this multiple of its own
# trajectory minimum has moved away from consensus (ADMM watchdog).
CONSENSUS_TREND_THRESH = 2.0


class DivergenceAbort(RuntimeError):
    """Raised by apps running with ``abort_on_divergence`` when the
    watchdog reports a diverged solve (after the structured
    ``run_aborted`` event is emitted)."""


def _np(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if hasattr(x, "detach"):  # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def quality_to_host(q) -> dict:
    """Materialize a ``SolveQuality`` (or the dict sagefit returns, or an
    already-converted dict) into ``{field: numpy array}`` with ``None``
    fields dropped.  Stacked leading axes (per-cluster quality of the
    SAGE EM passes) are preserved."""
    if q is None:
        return {}
    if isinstance(q, dict):
        # sagefit's {"em": per-cluster SolveQuality, "final": SolveQuality}
        return {k: quality_to_host(v) for k, v in q.items() if v is not None}
    d = q._asdict() if hasattr(q, "_asdict") else dict(q)
    return {k: _np(v) for k, v in d.items() if v is not None}


def _total_chi2(qd: dict) -> Optional[float]:
    ch = qd.get("chi2_chunk")
    if ch is None:
        return None
    return float(np.sum(ch))


def _station_chi2(qd: dict) -> Optional[np.ndarray]:
    st = qd.get("chi2_station")
    if st is None:
        return None
    st = np.asarray(st, float)
    # per-cluster stacks reduce to total attribution per station
    return st.reshape(-1, st.shape[-1]).sum(axis=0) if st.ndim > 1 else st


def assess_quality(
    qd: dict,
    chi2_outlier_ratio: float = CHI2_OUTLIER_RATIO,
    downweight_warn: float = DOWNWEIGHT_WARN_FRAC,
) -> Tuple[str, List[str]]:
    """Watchdog verdict for one solve's host-side quality dict.

    Returns ``(verdict, reasons)`` with verdict one of ``"ok"``,
    ``"degraded"``, ``"diverged"``.  Accepts the output of
    :func:`quality_to_host` on any solver's quality (missing fields are
    simply not checked); sagefit's ``{"em": ..., "final": ...}`` bundles
    are assessed on the ``final`` entry.
    """
    if "final" in qd or "em" in qd:
        qd = qd.get("final", qd.get("em", {}))
    reasons: List[str] = []
    diverged = False

    nf = qd.get("nonfinite_count")
    if nf is not None and float(np.sum(nf)) > 0:
        diverged = True
        reasons.append(f"nonfinite_gains:{int(np.sum(nf))}")

    st = _station_chi2(qd)
    if st is not None:
        if not np.all(np.isfinite(st)):
            diverged = True
            reasons.append("nonfinite_chi2")
        else:
            active = st[st > 0]
            med = float(np.median(active)) if active.size else 0.0
            if med > 0:
                bad = np.nonzero(st > chi2_outlier_ratio * med)[0]
                if bad.size:
                    reasons.append(
                        "station_chi2_outlier:"
                        + ",".join(str(int(b)) for b in bad)
                    )

    dw = qd.get("downweighted_frac")
    if dw is not None and float(np.max(dw)) > downweight_warn:
        reasons.append(f"downweighted_frac:{float(np.max(dw)):.3f}")

    if diverged:
        return "diverged", reasons
    return ("degraded", reasons) if reasons else ("ok", reasons)


def quality_summary(qd: dict) -> dict:
    """Compact JSON-ready summary of one solve's quality dict (full
    per-station / per-baseline arrays ride along for the heatmaps)."""
    if "final" in qd or "em" in qd:
        qd = qd.get("final", qd.get("em", {}))
    out: dict = {}
    tot = _total_chi2(qd)
    if tot is not None:
        out["chi2_total"] = tot
    st = _station_chi2(qd)
    if st is not None:
        out["chi2_station"] = st
        if st.size and np.all(np.isfinite(st)):
            out["chi2_station_worst"] = int(np.argmax(st))
    for k in ("chi2_baseline", "nonfinite_count", "nu", "weight_hist",
              "downweighted_frac", "flagged_frac", "station_amp",
              "station_amp_spread", "station_phase_spread",
              "identity_departure"):
        if qd.get(k) is not None:
            out[k] = qd[k]
    return out


def check_and_emit(
    elog,
    quality,
    log=None,
    **context,
) -> Tuple[str, List[str]]:
    """The app-side hook: assess one solve's quality, emit the
    ``solve_quality`` event (plus ``quality_degraded`` /
    ``solver_diverged`` on escalation), and refresh registry gauges.

    ``elog`` may be None (telemetry off) — the assessment still runs so
    the caller can abort on divergence either way.  ``context`` fields
    (tile, cluster, app, ...) are copied onto every emitted event.
    Returns ``(verdict, reasons)``.
    """
    qd = quality_to_host(quality)
    verdict, reasons = assess_quality(qd)
    summary = quality_summary(qd)

    reg = get_registry()
    if "chi2_total" in summary:
        reg.gauge_set("sagecal_quality_chi2_total", summary["chi2_total"],
                      help="total chi^2 of the latest solve")
    nf = summary.get("nonfinite_count")
    if nf is not None:
        reg.gauge_set("sagecal_quality_nonfinite_params",
                      float(np.sum(nf)),
                      help="non-finite gain parameters in the latest solve")
    dw = summary.get("downweighted_frac")
    if dw is not None:
        reg.gauge_set("sagecal_quality_downweighted_frac",
                      float(np.max(dw)),
                      help="fraction of unflagged data down-weighted "
                           "below 0.5 by the robust weights")
    if verdict != "ok":
        reg.counter_inc("sagecal_quality_watchdog_total",
                        help="watchdog escalations", verdict=verdict)

    if elog is not None:
        elog.emit("solve_quality", verdict=verdict, reasons=reasons,
                  **summary, **context)
        if verdict == "diverged":
            elog.emit("solver_diverged", reasons=reasons, **context)
        elif verdict == "degraded":
            elog.emit("quality_degraded", reasons=reasons, **context)
    if log is not None and verdict != "ok":
        log(f"quality watchdog: {verdict} ({', '.join(reasons)})")
    return verdict, reasons


def assess_consensus(primal_res_band, dual_res_band,
                     trend_thresh: float = CONSENSUS_TREND_THRESH, ages=None,
                     staleness: Optional[int] = None,
                     ) -> Tuple[str, List[str], dict]:
    """ADMM watchdog: per-band health from (nadmm, Nf) residual
    trajectories.  Returns ``(verdict, reasons, health)``, ``health``
    holding the per-band ``ratio`` / ``trend`` / ``diverged`` arrays of
    ``parallel/consensus.py::consensus_health``.  ``ages`` /
    ``staleness``: a bounded-staleness run's final ages and bound (the
    trend threshold relaxes by ``1 + age``; a band beyond the bound is
    starved, so diverged)."""
    from sagecal_tpu_torch.parallel.consensus import consensus_health

    pr = np.atleast_2d(np.asarray(_np(primal_res_band), float))
    du = np.atleast_2d(np.asarray(_np(dual_res_band), float))
    ratio, trend, diverged = consensus_health(
        pr, du, trend_thresh, ages=ages, staleness=staleness)
    health = {"ratio": ratio, "trend": trend, "diverged": diverged}
    bad = np.nonzero(diverged)[0]
    if bad.size:
        return "diverged", ["consensus_diverged_bands:" + ",".join(
            str(int(b)) for b in bad)], health
    return "ok", [], health


def check_hier_predict(elog, rel_err: float, bound: float, log=None,
                       **context) -> Tuple[str, List[str]]:
    """Watchdog of the hierarchical sky predict: the sampled
    a-posteriori error of a ``predict_coherencies_hier`` call
    (``sky/predict.py::sampled_error_estimate``) against the knob it
    must stay under (the app's ``hier_max_rel_err``).  Emits a
    ``hier_predict_check`` event, sets the ``sagecal_hier_predict_error``
    gauge, and escalates to a ``quality_degraded`` event and the
    watchdog counter when the knob is violated or the estimate is not
    finite.  Returns ``(verdict, reasons)``: ``"ok"`` or ``"degraded"``,
    never ``"diverged"`` (the solve watchdog owns that verdict)."""
    rel_err = float(rel_err)
    bound = float(bound)
    verdict, reasons = "ok", []
    if not np.isfinite(rel_err):
        verdict = "degraded"
        reasons.append("hier predict error is non-finite")
    elif rel_err > bound:
        verdict = "degraded"
        reasons.append(
            f"hier predict sampled rel err {rel_err:.3e} exceeds "
            f"bound {bound:.3e}")

    reg = get_registry()
    reg.gauge_set("sagecal_hier_predict_error",
                  rel_err if np.isfinite(rel_err) else -1.0,
                  help="sampled relative error of the latest "
                       "hierarchical sky prediction vs exact")
    if verdict != "ok":
        reg.counter_inc("sagecal_quality_watchdog_total",
                        help="watchdog escalations", verdict=verdict)

    if elog is not None:
        elog.emit("hier_predict_check", verdict=verdict, reasons=reasons,
                  rel_err=rel_err, bound=bound, **context)
        if verdict == "degraded":
            elog.emit("quality_degraded", reasons=reasons, **context)
    if log is not None and verdict != "ok":
        log(f"hier predict watchdog: {verdict} ({', '.join(reasons)})")
    return verdict, reasons


def abort_if_diverged(elog, verdict: str, reasons: Sequence[str],
                      **context) -> None:
    """The ``--abort-on-divergence`` exit path: emit a structured
    ``run_aborted`` event, close the log, and raise
    :class:`DivergenceAbort`."""
    if verdict != "diverged":
        return
    if elog is not None:
        elog.emit("run_aborted", reason="solver_diverged",
                  details=list(reasons), **context)
        elog.close()
    raise DivergenceAbort(
        "solver diverged (" + ", ".join(reasons) + "); aborting "
        "(abort_on_divergence)"
    )


# ---------------------------------------------------------------- heatmaps


def _lognorm(a: np.ndarray) -> np.ndarray:
    """Non-negative array -> [0,1] on a log1p scale (chi^2 spans orders
    of magnitude; linear scaling would show only the worst cell).
    Non-finite cells render hot (1.0)."""
    a = np.asarray(a, float)
    bad = ~np.isfinite(a)
    a = np.where(bad, 0.0, np.maximum(a, 0.0))
    v = np.log1p(a)
    top = float(v.max()) if v.size else 0.0
    out = v / top if top > 0 else np.zeros_like(v)
    return np.where(bad, 1.0, out)


def _upscale(img: np.ndarray, min_px: int = 256) -> np.ndarray:
    """Integer-replicate a small matrix so each cell is a visible block
    (PPM viewers do no interpolation)."""
    h, w = img.shape
    s = max(1, int(np.ceil(min_px / max(h, w, 1))))
    return np.kron(img, np.ones((s, s))) if s > 1 else img


def write_station_heatmap(chi2_station, path: str, min_px: int = 256):
    """Per-station chi^2 heatmap: rows = solves/tiles (or clusters),
    columns = stations, log-normalized blue->green->red."""
    a = np.atleast_2d(np.asarray(chi2_station, float))
    write_ppm(path, _upscale(_lognorm(a), min_px))


def write_baseline_heatmap(chi2_baseline, path: str, min_px: int = 256):
    """Per-baseline chi^2 heatmap: the (N, N) attribution symmetrized
    (rows scatter to (p, q) only), log-normalized."""
    a = np.asarray(chi2_baseline, float)
    a = a + a.T
    write_ppm(path, _upscale(_lognorm(a), min_px))
