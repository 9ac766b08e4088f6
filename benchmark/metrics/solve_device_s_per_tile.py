"""Device seconds a tile inside the tile solve (``solve_tile``: the EM
passes and the joint LBFGS), from the traced run's markers."""


def read(ctx):
    red = ctx.reduction
    if red is None or "solve" not in red.layer_busy_s:
        return None
    return red.layer_busy_s["solve"] / ctx.tiles
