"""route_roofline_pct.query: the least time the traced slice's routes
need over the profiler's device time of the kernels in
``route_roofline_pct.query.kernels.json``, in percent.  Each join routes
both relations; each route ranks its rows and scatters them into a
buffer of one slot a row, the least any route holds: every input byte
read once and every output byte (a row's lanes and its slot's valid
lane) written once, at the HBM's rate.  The rows and lanes are the
cell's shapes, never the router's own counts."""


def read(ctx):
    if ctx.trace is None:
        return None
    rf = ctx.roofline
    need = sum(rf.rank_bytes(rows, 1)
               + rf.scatter_bytes(rows, u["route_lanes"], rows)
               for u in ctx.trace.units if "route_rows" in u
               for rows in u["route_rows"])
    took = ctx.trace.device_s(ctx.spec.kernel_names(ctx.metric))
    if need <= 0 or took <= 0:
        return None
    return 100.0 * rf.seconds(need) / took
