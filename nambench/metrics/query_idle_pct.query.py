"""query_idle_pct.query: the share of the traced slice's ``db.execute``
spans in which no device operation ran, in percent: 1 - the union of the
device operations clipped to each span, over the spans' summed length.
Time between queries (the benchmark's own, the profiler's) counts for
neither."""
from nambench.queryspans import busy_us, queries


def read(ctx):
    qs = queries(ctx.trace)
    total = sum(e - s for s, e in qs)
    if total <= 0:
        return None
    busy = sum(busy_us(ctx.trace.device_ops, q) for q in qs)
    return 100.0 * (1.0 - busy / total)
