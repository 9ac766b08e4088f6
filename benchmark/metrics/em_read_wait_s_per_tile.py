"""Host seconds a tile spent waiting in the EM's device-to-host reads:
the summed durations of the ``read:*`` spans under ``sage.em`` (each
the host's wait for the card to drain up to the read) of the traced
app run, over its ``tile`` spans (``harness/program_record.py``)."""

from benchmark.harness import program_record


def read(ctx):
    t = program_record.tree()
    if t is None:
        return None
    return sum(s["dur"] for s in program_record.em_reads(t)) / len(t.tiles)
