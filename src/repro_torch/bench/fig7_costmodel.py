"""Fig 7: join cost analysis curves (both subfigures) from the §5.1
formulas, swept over the network-profile axis (a port of
``benchmarks/fig7_costmodel.py``).

The paper's Fig 7 point is a *crossover*: on 1GbE the semi-join reduction
(GHJ+Red) pays for almost any selectivity, on IPoIB only below ~0.8, and
on RDMA the one-sided variants (RDMA GHJ / RRJ) beat both.  Sweeping the
``NetworkProfile`` presets reproduces those curves in one run; the
``crossover`` rows record the per-profile argmin so the flip is explicit
in the CSV/JSON.  The figure is analytic: the card does no work for it.

    PYTHONPATH=src python -m repro_torch.bench.run --only fig7 --device cpu
"""
from repro_torch.bench import timing
from repro_torch.core import costmodel
from repro_torch.db import Planner
from repro_torch.fabric import netsim

DEFAULT_PROFILES = tuple(netsim.PROFILES)       # fig7 IS the axis figure
NR = NS = 1_000_000 * 8          # |R| = |S| = 1M tuples of 8 B
SELS = (0.1, 0.25, 0.5, 0.75, 1.0)


def run(profiles=None, timed=False, *, device=None):
    """(rows, extras).  ``device`` is accepted for the harness's sake:
    nothing here runs on a device."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    nr, ns = NR, NS
    rows = []
    crossover = {}
    for sel in SELS:
        winners = {}
        for name in profiles:
            prof = netsim.get_profile(name)
            ghj = costmodel.t_ghj(nr, ns, prof)
            red = costmodel.t_ghj_bloom(nr, ns, prof, sel)
            rows.append((f"fig7/{name}_sel{sel}_GHJ", ghj * 1e6, ""))
            rows.append((f"fig7/{name}_sel{sel}_GHJ+Red", red * 1e6,
                         "wins" if red < ghj else "loses"))
            if prof.rdma:
                rows.append((f"fig7/{name}_sel{sel}_RDMA_GHJ",
                             costmodel.t_rdma_ghj(nr, ns) * 1e6, ""))
                rows.append((f"fig7/{name}_sel{sel}_RRJ",
                             costmodel.t_rrj(nr, ns) * 1e6, ""))
            alts = Planner(net=name).join_alternatives(nr, ns, sel)
            winners[name] = Planner.chosen(alts)
        crossover[sel] = winners
        rows.append((f"fig7/crossover_sel{sel}", 0.0,
                     "|".join(f"{p}:{w}" for p, w in winners.items())))
    # the paper's claims
    assert costmodel.t_ghj_bloom(nr, ns, "ipoeth", 0.5) \
        < costmodel.t_ghj(nr, ns, "ipoeth")           # reduction wins on eth
    assert costmodel.t_ghj_bloom(nr, ns, "ipoib", 0.9) \
        > costmodel.t_ghj(nr, ns, "ipoib")            # loses at sel>0.8 IPoIB
    assert costmodel.t_rrj(nr, ns) <= costmodel.t_rdma_ghj(nr, ns)
    if len(profiles) > 1:
        # the axis must flip the argmin somewhere (the paper's thesis)
        assert any(len(set(w.values())) > 1 for w in crossover.values()), \
            f"no planner crossover across {profiles}"
    rows.append(("fig7/claims", 0.0, "all_hold"))
    extras = {"crossover": {str(s): w for s, w in crossover.items()},
              "profiles": {n: vars(netsim.get_profile(n))
                           for n in profiles}}
    if timed:
        # what is on this figure's hot path is the planner evaluation
        # itself (every db.explain / execute pays it): host code
        extras["measured_s"] = {
            "fig7/planner_join_alternatives": timing.device_time_s(
                lambda: Planner(net=profiles[0]).join_alternatives(
                    nr, ns, 0.5))}
    return rows, extras
