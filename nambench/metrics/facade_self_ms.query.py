"""facade_self_ms.query: mean milliseconds of a query's ``db.execute``
span outside its ``db.run`` and ``db.sync`` (planning, building the
operator, reading the counters, the result), over the traced slice's
queries: the inside twin of ``facade_ms.query``."""
from nambench.queryspans import per_query_ms, queries


def read(ctx):
    qs = queries(ctx.trace)
    if not qs:
        return None
    execute_ms = sum(e - s for s, e in qs) / len(qs) / 1e3
    return (execute_ms - per_query_ms(ctx.trace, "db.run")
            - per_query_ms(ctx.trace, "db.sync"))
