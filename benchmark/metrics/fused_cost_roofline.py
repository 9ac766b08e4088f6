"""Kernels #3 and #4 (the joint LBFGS's cost and gradient) against their
roofline: the least time of every launch in the traced run, at the
published peaks and the unpadded shapes of the channel-averaged tile
the solve fits, over the device time of their kernels (#3
``fused_cost_fwd_kernel``; #4 ``fused_cost_cot_kernel``,
``fused_cost_grad_kernel`` and ``sum_partials_kernel``, one launch a
cotangent kernel), in percent."""

from benchmark.harness import work

FWD = ("fused_cost_fwd_kernel",)
BWD = ("fused_cost_cot_kernel", "fused_cost_grad_kernel",
       "sum_partials_kernel")


def _ops(red, names):
    n = {k: 0 for k in names}
    s = 0.0
    for op, sec in red.op_seconds.items():
        for k in names:
            if k in op:
                n[k] += red.op_counts[op]
                s += sec
    return n, s


def read(ctx):
    red = ctx.reduction
    if red is None:
        return None
    nf, tf = _ops(red, FWD)
    nb, tb = _ops(red, BWD)
    launches_f, launches_b = nf[FWD[0]], nb[BWD[0]]
    if launches_f + launches_b == 0 or tf + tb <= 0:
        return None
    sh = ctx.shapes
    w = work.fused_cost(sh["M"], sh["nc"], sh["N"], 1, sh["rows"])
    least = (launches_f * work.least_seconds(*w["fwd"])
             + launches_b * work.least_seconds(*w["bwd"]))
    return 100.0 * least / (tf + tb)
