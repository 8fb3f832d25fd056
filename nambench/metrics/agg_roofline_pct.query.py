"""agg_roofline_pct.query: the least time the traced slice's grouped
aggregations need (the keys and values read once, the plan's table
written once, at the HBM's rate) over the profiler's device time of the
kernels in ``agg_roofline_pct.query.kernels.json``, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    rf = ctx.roofline
    need = sum(rf.agg_bytes(u["agg_rows"],
                            rf.agg_table_slots(u["variant"], u["groups"]))
               for u in ctx.trace.units if "groups" in u)
    took = ctx.trace.device_s(ctx.spec.kernel_names(ctx.metric))
    if need <= 0 or took <= 0:
        return None
    return 100.0 * rf.seconds(need) / took
