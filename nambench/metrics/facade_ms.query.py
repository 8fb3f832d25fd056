"""facade_ms.query: mean milliseconds of a query outside its operators:
its latency minus the facade's ``QueryResult.elapsed_s`` (planning,
result handling, the value's copy to the host), over the window."""


def read(ctx):
    units = [u for u in ctx.units if "elapsed_s" in u]
    if not units:
        return None
    return sum(u["latency_s"] - u["elapsed_s"] for u in units) / len(
        units) * 1e3
