"""Device seconds a tile inside the app's coherency builds
(``build_cluster_data``, both views), from the traced run's markers."""


def read(ctx):
    red = ctx.reduction
    if red is None or "coherencies" not in red.layer_busy_s:
        return None
    return red.layer_busy_s["coherencies"] / ctx.tiles
