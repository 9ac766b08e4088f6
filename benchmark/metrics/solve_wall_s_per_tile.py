"""Host seconds of the tile solve (``solve_tile``, which ends on the
device's synchronize after the joint LBFGS), the mean over the window's
tiles, from the benchmark's spans around the call (no profiler)."""


def read(ctx):
    spans = ctx.spans.get("solve")
    if not spans:
        return None
    return sum(spans) / len(spans)
