"""Device-to-host reads inside the EM a tile: the ``read:*`` spans under
``sage.em`` (``solvers/sage.py``'s per-cluster LM stopping tests, plan
comparisons, nerr reads, ``linalg.solve``'s checks; ``obs/trace.py::
host_read``) of the traced app run, over its ``tile`` spans
(``harness/program_record.py``)."""

from benchmark.harness import program_record


def read(ctx):
    t = program_record.tree()
    if t is None:
        return None
    return len(program_record.em_reads(t)) / len(t.tiles)
