"""plan_ms.query: mean milliseconds a query spends in ``db.plan`` (the
facade costing its alternatives and picking one), over the traced
slice's queries."""
from nambench.queryspans import per_query_ms


def read(ctx):
    return per_query_ms(ctx.trace, "db.plan")
