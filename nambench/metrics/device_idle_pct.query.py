"""device_idle_pct.query: the share of the traced slice in which no device
operation ran (1 - the union of their intervals / the slice), percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
