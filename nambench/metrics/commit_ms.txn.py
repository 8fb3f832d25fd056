"""commit_ms.txn: mean milliseconds of the benchmark's span around one
wave's ``Database.commit``, over the window."""


def read(ctx):
    spans = [u["commit_s"] for u in ctx.units if "commit_s" in u]
    return sum(spans) / len(spans) * 1e3 if spans else None
