"""session_ms.txn: mean milliseconds of the benchmark's span around
building one wave's sessions (begin, get, put), over the window."""


def read(ctx):
    spans = [u["session_s"] for u in ctx.units if "session_s" in u]
    return sum(spans) / len(spans) * 1e3 if spans else None
