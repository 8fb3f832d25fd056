"""issue_ms.query: mean milliseconds a query spends in ``db.run``: the
host issuing the operator's work to the device, over the traced slice's
queries."""
from nambench.queryspans import per_query_ms


def read(ctx):
    return per_query_ms(ctx.trace, "db.run")
