"""Calibration of every tile (``-a 0``): the coherencies of the averaged
and full-channel views, the EM passes and the joint LBFGS on #3/#4, the
solutions file, and the residual through #1 written back.  Checked by
``resid_gap``, ``cost_gap``, ``tile_res_ratio``, ``fit_cost_gap``,
``fit_grad_gap`` and ``fit_drop``; reports ``res_ratio``."""

from benchmark.harness import check, fullbatch

SPEC = fullbatch.Spec(
    flags=lambda obs: ["-a", "0"],
    judge=check.calibrate_numbers,
    layers={"build_cluster_data": "coherencies", "solve_tile": "solve",
            "calculate_residuals": "residual"},
    keep_solutions=True, record_fits=True)


def run(cell) -> fullbatch.Outcome:
    return fullbatch.run(cell, SPEC)
