"""query_p95_ms: the 95th percentile of every query of the window, each
from issue until its result is in hand (linear interpolation)."""
import numpy as np


def read(ctx):
    if not ctx.units or "elapsed_s" not in ctx.units[0]:
        return None
    return float(np.percentile([u["latency_s"] for u in ctx.units], 95)
                 ) * 1e3
