"""route_bytes_per_query.query: mean bytes the router billed a query
(``QueryResult.stats["route"]``), over the window."""


def read(ctx):
    units = [u for u in ctx.units if "route_bytes" in u]
    return sum(u["route_bytes"] for u in units) / len(units) \
        if units else None
