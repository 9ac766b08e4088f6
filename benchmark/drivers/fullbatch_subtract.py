"""Subtraction of the sky corrupted by known gains (``-a 3 -q``, the
observation's true gains): the full-channel coherencies and #1, written
back to the ``model`` column; no solve.  Checked by ``resid_gap``."""

from benchmark.harness import check, fullbatch

SPEC = fullbatch.Spec(
    flags=lambda obs: ["-a", "3", "-q", obs.truth_path],
    judge=check.subtract_numbers,
    layers={"build_cluster_data": "coherencies",
            "simulate_visibilities": "residual"},
    keep_solutions=False)


def run(cell) -> fullbatch.Outcome:
    return fullbatch.run(cell, SPEC)
