"""Kernel #1 (the model of every cluster under its gains, the residual
or subtraction step) against its roofline: the least time of every
launch in the traced run, at the published peaks and the unpadded
full-channel tile, over the device time of ``fused_predict_fwd_kernel``,
in percent."""

from benchmark.harness import work


def read(ctx):
    red = ctx.reduction
    if red is None:
        return None
    n, t = 0, 0.0
    for op, sec in red.op_seconds.items():
        if "fused_predict_fwd_kernel" in op:
            n += red.op_counts[op]
            t += sec
    if n == 0 or t <= 0:
        return None
    sh = ctx.shapes
    least = work.least_seconds(*work.fused_predict(sh["M"], sh["nc"],
                                                   sh["N"], sh["F"],
                                                   sh["rows"]))
    return 100.0 * n * least / t
