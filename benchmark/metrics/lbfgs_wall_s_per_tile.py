"""Host seconds of the joint LBFGS a tile: the ``sage.lbfgs`` spans of
the traced app run (``solvers/sage.py::sagefit``, synchronized at both
ends, ``SageResult.phase_seconds["lbfgs"]``'s stamps), over its
``tile`` spans (``harness/program_record.py``)."""

from benchmark.harness import program_record


def read(ctx):
    t = program_record.tree()
    if t is None or not t.named("sage.lbfgs"):
        return None
    return sum(s["dur"] for s in t.named("sage.lbfgs")) / len(t.tiles)
