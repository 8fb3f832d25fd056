"""sync_wait_ms.query: mean milliseconds a query spends in ``db.sync``:
the host waiting for the device to finish the operator's work after
issuing it, over the traced slice's queries."""
from nambench.queryspans import per_query_ms


def read(ctx):
    return per_query_ms(ctx.trace, "db.sync")
