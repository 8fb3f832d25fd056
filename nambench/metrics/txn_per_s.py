"""txn_per_s: committed checkouts over the window's seconds (a checkout
run again after an abort counts once, when it commits)."""


def read(ctx):
    if not ctx.units or "committed" not in ctx.units[0]:
        return None
    return sum(u["committed"] for u in ctx.units) / ctx.window_s
