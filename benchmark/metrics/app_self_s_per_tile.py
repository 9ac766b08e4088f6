"""Host seconds a tile of the app's own work: each ``tile`` span of the
traced app run less the part its ``coherencies``, ``solve`` and
``residual`` children cover (the reader's wait, the copies to the card,
the read-back, the solutions and the written column), over the
``tile`` spans (``harness/program_record.py``)."""

from benchmark.harness import program_record

LAYERS = ("coherencies", "solve", "residual")


def _covered(ivals):
    total, end = 0.0, None
    for s, e in sorted(ivals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read(ctx):
    t = program_record.tree()
    if t is None:
        return None
    own = 0.0
    for tile in t.tiles:
        t0, t1 = tile["ts"], tile["ts"] + tile["dur"]
        kids = [(max(c["ts"], t0), min(c["ts"] + c["dur"], t1))
                for c in t.children(tile) if c["name"] in LAYERS]
        own += tile["dur"] - _covered([iv for iv in kids if iv[1] > iv[0]])
    return own / len(t.tiles)
