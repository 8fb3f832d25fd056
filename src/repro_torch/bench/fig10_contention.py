"""Fig 10 in the port: the fabric under load, through the contention
simulator (:mod:`repro_torch.fabric.sim`).

The counterpart of ``benchmarks/fig10_contention.py``.  Three panels,
each asserted inline as in the JAX benchmark:

(a) **Throughput vs outstanding-request window** for WRITE- and
    SEND-style verbs: one client streams fixed-size ops at a server with
    at most W in flight.  Asserted: the curve rises then plateaus, and
    WRITE out-rates SEND at saturation (by 1.25x on RDMA profiles).

(b) **The planner's load crossover**: ``db.explain(load=L)`` prices the
    same join under L concurrent tenant streams.  RRJ ships both full
    relations through its fused pass, unbeatable on an idle EDR wire;
    GHJ+Red ships only the bloom-reduced fraction, so the argmin flips
    rrj -> ghj_bloom as load rises at a fixed profile.  Asserted on every
    RDMA profile of the run.

(c) **Record -> replay**: a real workload traced off a live transport
    (``Transport(tracer=EventTracer())``) and replayed on every profile
    beside the analytic serial sum and the work-conservation lower bound.
    Asserted: lower bound <= makespan, and a single agent at window 1
    replays exactly the analytic ``t_call`` sum.

:func:`run` is the JAX benchmark's figure at its sizes (its rows equal
the JAX benchmark's); under ``timed`` it adds the JAX benchmark's
``measured_s``: the host seconds of a window sweep, of a replay of the
recorded workload and of a contended-profile fit.  :func:`record_join` and :func:`replay_rows` trace
one forced join of a loaded ``Database`` (at the paper's 128M tuples a
relation on the card) and replay it on every profile.
"""
from __future__ import annotations

import torch

from repro_torch.bench import timing
from repro_torch.db import Database
from repro_torch.fabric import LocalTransport, netsim, sim

DEFAULT_PROFILES = ("rdma_edr",)    # the fastest wire: contention is the
                                    # only thing left to hurt you
WINDOWS = (1, 2, 4, 8, 16, 32, 64)
OP_BYTES = 4096
N_OPS = 256
LOADS = (0, 8, 64)                  # concurrent tenant streams
JOIN_SEL = 0.25                     # bloom-reduced fraction that flips it
REPLAY_NODES = 4                    # the paper's 4-node cluster
EXACT = 1e-9                        # relative: window-1 replay vs analytic


def sweep_rows(pname: str, rows: list) -> dict:
    """Panel (a): window sweep, write vs send, plus a 4-tenant contention
    point.  Returns {verb: curve} and appends rows; asserts saturation."""
    prof = netsim.get_profile(pname)
    curves = {}
    for verb in ("write", "send"):
        curve = sim.window_sweep(prof, verb=verb, op_bytes=OP_BYTES,
                                 n_ops=N_OPS, windows=WINDOWS)
        curves[verb] = curve
        for w, tput in curve.items():
            rows.append((f"fig10/{pname}_{verb}_w{w}", 1e6 / tput,
                         f"{tput / 1e6:.3f}Mops"))
        t1, t16, t64 = curve[1], curve[16], curve[64]
        sat = max(curve.values())
        # the curve saturates, not monotone-linear: it rises from W=1,
        # then the last two doublings add next to nothing
        assert sat / t1 > 1.5, \
            f"{pname}/{verb}: no window gain ({sat / t1:.2f}x)"
        assert t64 / t16 < 1.2, \
            f"{pname}/{verb}: still linear at W=64 ({t64 / t16:.2f}x)"
        rows.append((f"fig10/{pname}_{verb}_saturation", 1e6 / sat,
                     f"{sat / t1:.1f}x_over_w1"))
    wsat, ssat = max(curves["write"].values()), max(curves["send"].values())
    assert wsat >= ssat * (1.25 if prof.rdma else 0.999), \
        f"{pname}: WRITE ({wsat:.0f}) should out-rate SEND ({ssat:.0f})"
    # 4 clients share the server ingress at a fixed window: per-tenant
    # throughput collapses toward sat/4
    t4 = sim.window_sweep(prof, verb="write", op_bytes=OP_BYTES,
                          n_ops=N_OPS, windows=(16,), tenants=4)[16]
    rows.append((f"fig10/{pname}_write_4tenants_w16", 1e6 / (t4 / 4),
                 f"{t4 / 4e6:.3f}Mops_per_tenant"))
    return curves


def join_query(db, sel: float = JOIN_SEL):
    """``scan(R).join(scan(S).filter(sel)).aggregate()`` of a database
    holding R and S."""
    return db.scan("R").join(db.scan("S").filter(sel=sel)).aggregate()


def planner_rows(db, q, profiles, rows: list, loads=LOADS) -> dict:
    """Panel (b): the chosen join variant of ``q`` at each load on each
    profile.  Asserts the flip on every RDMA profile."""
    crossover = {}
    for pname in profiles:
        winners = {}
        for load in loads:
            ex = db.explain(q, profile=pname, load=load)
            winners[str(load)] = ex.chosen
            costs = "|".join(f"{a.name}:{a.cost_s * 1e6:.1f}us"
                             for a in ex.alternatives if a.feasible)
            rows.append((f"fig10/planner_{pname}_load{load}", 0.0,
                         f"picked_{ex.chosen}_{costs}"))
        crossover[pname] = winners
        rows.append((f"fig10/planner_{pname}_crossover", 0.0,
                     "|".join(f"L{k}:{v}" for k, v in winners.items())))
    for pname in profiles:
        if netsim.get_profile(pname).rdma:
            # on a fixed RDMA profile the argmin flips with load alone
            assert len(set(crossover[pname].values())) > 1, \
                f"no load crossover on {pname}: {crossover[pname]}"
    return crossover


def trace_workload(device=None):
    """A small real workload recorded off a live transport: a planned,
    windowed, plan-reusing route round plus point verbs.  Returns (the
    trace, the transport's counters)."""
    tracer = sim.EventTracer()
    tp = LocalTransport(tracer=tracer, device=device)
    dev = tp.device
    keys = torch.arange(4096, dtype=torch.int32, device=dev)
    dest = torch.zeros((4096,), dtype=torch.int32, device=dev)
    plan = tp.plan_route(dest, cap=4096, window=8)
    tp.route({"k": keys}, plan=plan)
    tp.route({"k": keys}, plan=plan)         # plan-reuse round
    words = torch.zeros((4096,), dtype=torch.int32, device=dev)
    idx = torch.arange(256, dtype=torch.int32, device=dev)
    with tracer.agent("writer"):
        tp.write(words, idx, torch.ones((256,), dtype=torch.int32,
                                        device=dev))
    with tracer.agent("reader"):
        tp.read(words, idx)
    tp.fetch_add(words, torch.zeros((4,), dtype=torch.int32, device=dev),
                 torch.ones((4,), dtype=torch.int32, device=dev))
    return tracer.events, tp.stats()


def replay_rows(trace, profiles, rows: list, label: str = "") -> dict:
    """Panel (c): ``trace`` replayed at window 2 on every profile beside
    its analytic sum and lower bound (asserted <= makespan), then a
    window-1 check.  Without ``label``, as the JAX benchmark runs it: a
    32-WRITE probe whose window-1 replay is the analytic sum.  With
    ``label`` (a recorded join, :func:`record_join`): the trace itself,
    whose one agent's point calls replay at window 1 to the analytic
    serial sum."""
    info = {}
    name = f"fig10/replay_{label}_" if label else "fig10/replay_"
    for pname in profiles:
        prof = netsim.get_profile(pname)
        res = sim.replay(trace, prof, nodes=REPLAY_NODES, window=2)
        iso = sim.analytic_time(trace, prof)
        lb = sim.analytic_lower_bound(trace, prof, nodes=REPLAY_NODES)
        assert lb <= res.makespan, \
            f"{label}/{pname}: sim beat the work-conservation bound"
        rows.append((f"{name}{pname}", res.makespan * 1e6,
                     f"analytic_{iso * 1e6:.1f}us_lb_{lb * 1e6:.1f}us"))
        info[pname] = {"sim_s": res.makespan, "analytic_s": iso,
                       "lower_bound_s": lb,
                       "queue_depth_hist": res.queue_depth_hist}
        if label:
            w1 = sim.replay(trace, prof, nodes=REPLAY_NODES,
                            window=1).makespan
            assert abs(w1 - iso) <= EXACT * max(iso, 1e-30), \
                f"{label}/{pname}: window-1 replay {w1} != analytic {iso}"
            info[pname].update(window1_s=w1, events=len(trace))
            continue
        # uncontended limit == analytic t_call sum, exactly
        probe = [sim.SimEvent(seq=i, verb="write", msgs=1.0,
                              nbytes=float(OP_BYTES), src=0, dst=1)
                 for i in range(32)]
        serial = sim.FabricSim(prof, nodes=2, window=1).run(probe)
        ana = sim.analytic_time(probe, prof)
        assert abs(serial.makespan - ana) <= EXACT * max(ana, 1e-30), \
            f"{pname}: uncontended sim {serial.makespan} != analytic {ana}"
        rows.append((f"fig10/uncontended_{pname}", serial.makespan * 1e6,
                     "sim==analytic_t_call"))
    return info


def record_join(db, q, variant: str):
    """One execution of ``q`` forced to ``variant`` with an
    ``EventTracer`` on the database's transport for that call alone.
    Returns (the trace, the ``QueryResult``)."""
    tracer = sim.EventTracer()
    db.transport.tracer = tracer
    try:
        res = db.execute(q, force_variant=variant)
    finally:
        db.transport.tracer = None
    return tracer.events, res


def run(profiles=None, timed=False, *, device=None):
    """The whole figure at the JAX benchmark's sizes: (rows, extras)."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    rows: list = []
    windows = {}
    for pname in profiles:
        curves = sweep_rows(pname, rows)
        windows[pname] = {v: {str(w): t for w, t in c.items()}
                          for v, c in curves.items()}

    db = Database(device=device, net=profiles[0])
    n = 4096
    keys = torch.arange(1, n + 1, dtype=torch.int32, device=db.device)
    db.load_table("R", keys, keys)
    db.load_table("S", keys, keys)
    crossover = planner_rows(db, join_query(db), profiles, rows)

    trace, fabric_stats = trace_workload(device)
    replay_info = replay_rows(trace, profiles, rows)
    extras = {"windows": windows, "crossover": crossover,
              "replay": replay_info, "fabric": fabric_stats}
    if timed:
        # the simulator is host code: nothing to synchronize
        prof0 = netsim.get_profile(profiles[0])
        extras["measured_s"] = {
            "fig10/sim_window_sweep": timing.device_time_s(
                lambda: sim.window_sweep(prof0, verb="write",
                                         op_bytes=OP_BYTES, n_ops=N_OPS,
                                         windows=WINDOWS), warmup=1, k=3),
            "fig10/sim_replay": timing.device_time_s(
                lambda: sim.replay(trace, prof0, nodes=REPLAY_NODES,
                                   window=2), warmup=1, k=3),
            "fig10/contended_profile_fit": timing.device_time_s(
                lambda: sim.contended_profile(prof0, 64), warmup=1, k=3)}
    return rows, extras
