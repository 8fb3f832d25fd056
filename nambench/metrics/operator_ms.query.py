"""operator_ms.query: mean ``QueryResult.elapsed_s`` (the operators, to
the device's end), in milliseconds, over the window."""


def read(ctx):
    units = [u for u in ctx.units if "elapsed_s" in u]
    return sum(u["elapsed_s"] for u in units) / len(units) * 1e3 \
        if units else None
