"""The share of the traced app run's host time in which no operation ran
on the device: 100 (1 - busy / window)."""


def read(ctx):
    red = ctx.reduction
    if red is None or red.window_s <= 0 or red.busy_s <= 0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)
