"""query_ms: the window's milliseconds over the queries it completed."""


def read(ctx):
    if not ctx.units or "elapsed_s" not in ctx.units[0]:
        return None
    return ctx.window_s * 1e3 / len(ctx.units)
