"""abort_share.txn: checkouts that failed (aborted on every run) over
checkouts finished, in percent, over the window (the facade's commit
outcomes)."""


def read(ctx):
    units = [u for u in ctx.units if "committed" in u]
    tried = sum(u["attempted"] for u in units)
    return 100.0 * sum(u["failed"] for u in units) / tried if tried else None
