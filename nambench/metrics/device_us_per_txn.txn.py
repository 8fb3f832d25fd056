"""device_us_per_txn.txn: microseconds of device operations (profiler)
over the checkouts committed in the traced slice."""


def read(ctx):
    if ctx.trace is None:
        return None
    done = sum(u.get("committed", 0) for u in ctx.trace.units)
    busy = ctx.trace.device_s()
    return busy * 1e6 / done if done and busy > 0 else None
