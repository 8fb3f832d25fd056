"""wire_bytes_per_txn.txn: bytes of every verb the transport counted
(``transport.stats()``) over committed checkouts, over the window."""


def read(ctx):
    units = [u for u in ctx.units if "committed" in u]
    done = sum(u["committed"] for u in units)
    return sum(u["wire_bytes"] for u in units) / done if done else None
