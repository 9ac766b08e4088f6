"""Host seconds of the EM passes a tile: the ``sage.em`` spans of the
traced app run (``solvers/sage.py::sagefit``, from the synchronized
clock before the EM to the one after it, the stamps of
``SageResult.phase_seconds["em"]``), over its ``tile`` spans
(``harness/program_record.py``)."""

from benchmark.harness import program_record


def read(ctx):
    t = program_record.tree()
    if t is None or not t.named("sage.em"):
        return None
    return sum(s["dur"] for s in t.named("sage.em")) / len(t.tiles)
