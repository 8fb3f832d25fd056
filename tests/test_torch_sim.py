"""The port's contention simulator, tracer and planning under load, held
against the JAX package.

  * the simulator is a copy: the same trace gives a bit-identical
    timeline, completions and port volumes in both packages, on every
    profile and under both schedulers, and its analytic anchors hold
    (a lone call is ``t_call``, window 1 is the analytic serial sum, no
    makespan beats the lower bound);
  * the port's transports emit tracer events equal to JAX's eager ones
    (``Database(jit=False)``) on a route, a commit with retries, a grouped
    commit with retries and a PS push;
  * ``Planner(load=)`` and ``Database.explain(load=)`` choose and price as
    JAX does at loads {0, 8, 64};
  * fig8a's ``replay`` row equals the JAX benchmark's.
"""
import dataclasses as dc
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig8a_joins as jfig8a
from benchmarks import workloads as jworkloads
from repro.analytics import ParameterServer as JaxPS
from repro.db import Database as JaxDatabase
from repro.db.planner import Planner as JaxPlanner
from repro.fabric import LocalTransport as JaxLocal
from repro.fabric import sim as jsim
from repro_torch.analytics import ParameterServer
from repro_torch.bench import fig8a_joins, fig_scale, workloads
from repro_torch.db import Database
from repro_torch.db.planner import Planner
from repro_torch.fabric import LocalTransport, netsim, sim

EDR = netsim.get_profile("rdma_edr")
ALL_PROFILES = sorted(netsim.PROFILES)


def _to_jax(trace):
    return [jsim.SimEvent(**dc.asdict(e)) for e in trace]


def _res(r):
    return (r.makespan, r.completions, r.latency, r.timeline,
            r.peak_outstanding, r.queue_depth_hist, r.port_bytes, r.util)


def _events(tracer):
    return [dc.astuple(e) for e in tracer.events]


def _same_run(trace, profile, **kw):
    """Run ``trace`` through both simulators; assert bit-identical
    results and return the port's."""
    name = profile if isinstance(profile, str) else profile.name
    ours = sim.FabricSim(profile, **kw).run(trace)
    theirs = jsim.FabricSim(name, **kw).run(_to_jax(trace))
    assert _res(ours) == _res(theirs)
    return ours


# ------------------------------------------- bit-identical replays ------

@pytest.mark.parametrize("scheduler", ["fair", "fcfs"])
@pytest.mark.parametrize("pname", ALL_PROFILES)
def test_synthetic_load_replays_bit_identical(pname, scheduler):
    trace = sim.synthetic_load(4, ops_per_tenant=6, op_bytes=12_345,
                               verb="send", spread_s=1e-5, seed=3)
    assert [dc.astuple(e) for e in trace] == [dc.astuple(e) for e in
                                              jsim.synthetic_load(
        4, ops_per_tenant=6, op_bytes=12_345, verb="send",
        spread_s=1e-5, seed=3)]
    _same_run(trace, pname, nodes=5, window=2, scheduler=scheduler)


@pytest.mark.parametrize("seed", range(6))
def test_random_traces_replay_bit_identical(seed):
    rng = random.Random(seed)
    trace = []
    for i in range(40):
        verb = rng.choice(["write", "read", "send", "route", "compute"])
        trace.append(sim.SimEvent(
            seq=i, verb=verb, msgs=float(rng.randint(0, 8)),
            nbytes=float(rng.randint(0, 1 << 18)),
            agent=f"a{rng.randint(0, 3)}",
            src=rng.choice([None, 0, 1, 2]),
            dst=rng.choice([None, 0, 3, sim.ALL]),
            window=rng.randint(0, 3), at=rng.uniform(0, 1e-5),
            compute_s=rng.uniform(0, 1e-5) if verb == "compute" else 0.0))
    for pname in ("rdma_edr", "ethernet_1g"):
        ours = _same_run(trace, pname, nodes=4, window=rng.randint(0, 3),
                         windows={"a0": 1})
        lb = sim.analytic_lower_bound(trace, pname, nodes=4)
        assert lb == jsim.analytic_lower_bound(_to_jax(trace), pname,
                                               nodes=4)
        assert ours.makespan >= lb * (1 - 1e-9)
        assert sim.analytic_time(trace, pname) == \
            jsim.analytic_time(_to_jax(trace), pname)


def test_fig_scale_trace_replays_bit_identical():
    st, sets, att, tids = fig_scale.run_economics(8, 1.2, device="cpu")
    trace = fig_scale.commit_trace(sets, att, tids, 8,
                                   fig_scale.assign_workers(8, 8))
    _same_run(trace, "rdma_fdr4x", nodes=8, window=2, windows={"grant": 0})


def test_experiments_equal_jax():
    for verb in ("write", "send"):
        assert sim.window_sweep(EDR, verb=verb, op_bytes=4096,
                                n_ops=64, tenants=2) == \
            jsim.window_sweep("rdma_edr", verb=verb, op_bytes=4096,
                              n_ops=64, tenants=2)
    for load in (0, 8, 64):
        assert dc.astuple(sim.contended_profile(EDR, load)) == \
            dc.astuple(jsim.contended_profile("rdma_edr", load))
    for w in (0, 1, 4):
        assert sim.read_storm("rdma_edr", n_reads=32, block_bytes=1024,
                              window=w, clients=2) == \
            jsim.read_storm("rdma_edr", n_reads=32, block_bytes=1024,
                            window=w, clients=2)


# ------------------------------------------------- analytic anchors ------

@pytest.mark.parametrize("pname", ALL_PROFILES)
def test_single_call_is_exactly_t_call(pname):
    p = netsim.get_profile(pname)
    ev = sim.SimEvent(seq=0, verb="write", msgs=4, nbytes=65536,
                      src=0, dst=1)
    res = _same_run([ev], p, nodes=2)
    assert res.makespan == pytest.approx(p.t_call(4, 65536), rel=1e-12)
    assert res.latency[0] == res.makespan


@pytest.mark.parametrize("pname", ALL_PROFILES)
def test_serial_window1_equals_analytic_sum(pname):
    p = netsim.get_profile(pname)
    trace = [sim.SimEvent(seq=i, verb="write", msgs=1 + i % 3,
                          nbytes=1024 * (1 + i % 5), agent="a",
                          src=0, dst=1) for i in range(40)]
    res = _same_run(trace, p, nodes=2, window=1)
    assert res.makespan == pytest.approx(sim.analytic_time(trace, p),
                                         rel=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_makespan_never_beats_lower_bound_seeded(seed):
    rng = random.Random(seed)
    trace = sim.synthetic_load(rng.randint(1, 4),
                               ops_per_tenant=rng.randint(1, 6),
                               op_bytes=rng.randint(1, 1 << 16),
                               verb=rng.choice(["write", "send", "read"]),
                               spread_s=1e-5, seed=seed)
    nodes = rng.randint(2, 5)
    for scheduler in ("fair", "fcfs"):
        res = _same_run(trace, EDR, nodes=nodes,
                        window=rng.randint(0, 4), scheduler=scheduler)
        lb = sim.analytic_lower_bound(trace, EDR, nodes=nodes)
        assert res.makespan >= lb * (1 - 1e-9)
        assert len(res.completions) == len(trace)


def test_fair_share_and_queue_histogram():
    B = 1 << 20
    trace = [sim.SimEvent(seq=0, verb="write", msgs=1, nbytes=B,
                          agent="a", src=0, dst=2),
             sim.SimEvent(seq=1, verb="write", msgs=1, nbytes=B,
                          agent="b", src=1, dst=2)]
    res = _same_run(trace, EDR, nodes=3)
    expect = EDR.setup_s + EDR.per_message_s + 2 * B / EDR.bandwidth
    assert res.makespan == pytest.approx(expect, rel=1e-9)
    trace = [sim.SimEvent(seq=i, verb="write", msgs=1, nbytes=4096,
                          agent="a", src=0, dst=1) for i in range(8)]
    res = _same_run(trace, EDR, nodes=2, window=1)
    assert res.queue_depth_hist == {d: 1 for d in range(8)}
    assert res.peak_outstanding == {"write": 1}


def test_invalid_scheduler_rejected_and_percentile():
    with pytest.raises(ValueError, match="scheduler"):
        sim.FabricSim(EDR, scheduler="lifo")
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert sim.percentile(vals, q) == jsim.percentile(vals, q)
    with pytest.raises(ValueError):
        sim.percentile([], 0.5)
    trace = sim.synthetic_load(2, ops_per_tenant=4, seed=1)
    res = sim.replay(trace, EDR, nodes=3, window=1)
    jres = jsim.replay(_to_jax(trace), "rdma_edr", nodes=3, window=1)
    assert sim.completion_gaps(res, [0, 2, 5]) == \
        jsim.completion_gaps(jres, [0, 2, 5])


# -------------------------------------------------- tracer parity -------

def test_tracer_route_and_point_verbs_equal_jax():
    def drive(tp, tracer, arr, ones, idx, zeros):
        with tracer.agent("w0"):
            tp.write(arr(64), idx(8), ones(8))
        tp.read(arr(64), idx(8))
        plan = tp.plan_route(zeros(64), cap=64, window=4)
        tp.route({"k": arr(64), "v": ones(64)}, plan=plan, chunks=8)
        tp.route({"k": arr(8)}, zeros(8), cap=8, window=4)
        with tracer.agent("ctr", node=2):
            tp.fetch_add(arr(4), zeros(3), ones(3))
        tracer.emit_compute(3e-5)
        tp.cas(arr(16), idx(4), arr(4), ones(4))
        return tp.stats()

    jt = jsim.EventTracer()
    jstats = drive(JaxLocal(tracer=jt), jt,
                   lambda n: jnp.zeros((n,), jnp.uint32),
                   lambda n: jnp.ones((n,), jnp.uint32),
                   lambda n: jnp.arange(n, dtype=jnp.int32),
                   lambda n: jnp.zeros((n,), jnp.int32))
    pt = sim.EventTracer()
    pstats = drive(LocalTransport(tracer=pt, device="cpu"), pt,
                   lambda n: torch.zeros((n,), dtype=torch.int32),
                   lambda n: torch.ones((n,), dtype=torch.int32),
                   lambda n: torch.arange(n, dtype=torch.int32),
                   lambda n: torch.zeros((n,), dtype=torch.int32))
    assert _events(pt) == _events(jt)
    assert pstats == jstats
    assert sum(v["calls"] for v in pstats.values()) == len(pt.events) - 1


def _acct_waves(db, wave_recs):
    t = db.create_table("acct", 32, payload_words=2, num_timestamps=256)
    t.seed(np.arange(16), vals=np.ones((16, 2), np.uint32))
    masks = []
    for recs in wave_recs:
        ss = []
        for i, r in enumerate(recs):
            s = db.session().begin()
            s.put("acct", r, np.full((len(r), 2), i + 1, np.uint32),
                  read_cids=np.ones(len(r), np.uint32))
            ss.append(s)
        masks.append(db.commit(ss, max_retries=2))
    return masks


def test_tracer_commit_with_retries_equals_jax():
    waves = [[[0, 1], [1, 2], [0, 3], [4, 5]], [[6, 0], [0, 7]]]
    jt, pt = jsim.EventTracer(), sim.EventTracer()
    jdb = JaxDatabase(JaxLocal(tracer=jt), jit=False)
    pdb = Database(LocalTransport(tracer=pt, device="cpu"))
    jm, pm = _acct_waves(jdb, waves), _acct_waves(pdb, waves)
    assert [m.tolist() for m in pm] == [np.asarray(m).tolist() for m in jm]
    assert pdb.txn_stats == jdb.txn_stats and pdb.txn_stats["retries"]
    assert any(e.verb == "compute" for e in pt.events)
    assert _events(pt) == _events(jt)


def test_tracer_grouped_commit_with_retries_equals_jax():
    sets = workloads.worker_write_sets(4, 4, 2, 256, skew=1.2, seed=5)
    jsets = jworkloads.worker_write_sets(4, 4, 2, 256, skew=1.2, seed=5)
    assert all(np.array_equal(a, b) for a, b in zip(sets, jsets))
    jt = jsim.EventTracer()
    jdb = JaxDatabase(JaxLocal(tracer=jt), jit=False)
    t = jdb.create_table("acct", 256, payload_words=1, num_timestamps=2048)
    t.seed(np.arange(256), np.arange(256).reshape(-1, 1))
    jgroups = []
    for wsets in jsets:
        g = []
        for recs in wsets:
            s = jdb.session().begin()
            s.put("acct", recs, np.ones((len(recs), 1), np.uint32),
                  read_cids=np.ones(len(recs), np.uint32))
            g.append(s)
        jgroups.append(g)
    jdb.commit_grouped(jgroups, max_retries=3)
    pdb = fig_scale.economics_db(records=256, device="cpu")
    pt = pdb.transport.tracer = sim.EventTracer()
    pdb.commit_grouped(fig_scale.groups_of(pdb, sets), max_retries=3)
    assert pdb.txn_stats == jdb.txn_stats and pdb.txn_stats["retries"]
    assert _events(pt) == _events(jt)


def test_tracer_ps_push_equals_jax():
    w = np.linspace(-1, 1, 96, dtype=np.float32).reshape(12, 8)
    jt, pt = jsim.EventTracer(), sim.EventTracer()
    jps = JaxPS({"w": jnp.asarray(w)}, transport=JaxLocal(tracer=jt),
                block=8, num_shards=4, staleness=1)
    pps = ParameterServer({"w": torch.from_numpy(w)},
                          transport=LocalTransport(tracer=pt, device="cpu"),
                          block=8, num_shards=4, staleness=1)
    for step in range(2):
        g = np.full((12, 8), 0.1 * (step + 1), np.float32)
        jps.pull(worker=0)
        jps.push({"w": jnp.asarray(g)}, worker=0)
        pps.pull(worker=0)
        pps.push({"w": torch.from_numpy(g)}, worker=0)
    assert {e.verb for e in pt.events} >= {"read", "route", "fetch_add"}
    assert _events(pt) == _events(jt)


# ------------------------------------------------ planning under load ---

@pytest.mark.parametrize("load", [0, 8, 64])
@pytest.mark.parametrize("pname", ["rdma_edr", "rdma_fdr4x", "ethernet_1g"])
def test_planner_under_load_equals_jax(pname, load):
    def alts(a):
        return [(x.name, x.cost_s, x.feasible, x.chosen) for x in a]
    ours, theirs = Planner(net=pname, load=load), \
        JaxPlanner(net=pname, load=load)
    for nr, sel in ((int(8e6), 0.25), (int(1e9), 0.5), (4096, 1.0)):
        assert alts(ours.join_alternatives(nr, nr, sel)) == \
            alts(theirs.join_alternatives(nr, nr, sel))
    for groups in (64, 1 << 20):
        assert alts(ours.agg_alternatives(int(1e9), groups)) == \
            alts(theirs.agg_alternatives(int(1e9), groups))
    ours.calibrate({"route": {"bytes": 1 << 20}}, 1e-3)
    theirs.calibrate({"route": {"bytes": 1 << 20}}, 1e-3)
    assert ours.effective_net == theirs.effective_net


def test_planner_argmin_flips_with_load_on_fixed_profile():
    nr = ns = int(8e6)
    chosen = {L: Planner.chosen(Planner(net="rdma_edr", load=L)
                                .join_alternatives(nr, ns, sel=0.25))
              for L in (0, 8, 64)}
    assert chosen == {0: "rrj", 8: "rrj", 64: "ghj_bloom"}


def test_database_explain_load_equals_jax():
    jdb = JaxDatabase(net="rdma_edr")
    pdb = Database(device="cpu", net="rdma_edr")
    keys = np.arange(1, 1025, dtype=np.uint32)
    jdb.load_table("R", jnp.asarray(keys), jnp.asarray(keys))
    jdb.load_table("S", jnp.asarray(keys), jnp.asarray(keys))
    pdb.load_table("R", keys, keys)
    pdb.load_table("S", keys, keys)
    for db in (jdb, pdb):
        db.q = db.scan("R").join(db.scan("S").filter(sel=0.25)).aggregate()
    for load in (0, 8, 64):
        for profile in (None, "ipoib_fdr"):
            je = jdb.explain(jdb.q, profile=profile, load=load)
            pe = pdb.explain(pdb.q, profile=profile, load=load)
            assert pe.chosen == je.chosen and pe.inputs == je.inputs
            assert [(a.name, a.cost_s) for a in pe.alternatives] == \
                [(a.name, a.cost_s) for a in je.alternatives]
    assert pdb.explain(pdb.q, load=64).chosen == "ghj_bloom"
    assert pdb.planner.load == 0                # db state untouched


# ---------------------------------------------------- fig8a replay ------

@pytest.mark.parametrize("pname", ["rdma_fdr4x", "ethernet_1g"])
def test_fig8a_replay_row_equals_jax(pname):
    for n, cap, chunks in ((2, 1 << 20, 4), (4, 1 << 16, 2)):
        assert fig8a_joins.route_replay_pricing(pname, n, cap, chunks) == \
            jfig8a._route_replay_pricing(pname, n, cap, chunks)
    # the figure's row: JAX prices its one-device mesh on 2 nodes
    n = 1 << 20
    assert fig8a_joins.replay_row(n, (pname,)) == \
        jfig8a._route_replay_pricing(pname, 2, 2 * n // 2,
                                     jfig8a.ROUTE_CHUNKS)
    row = fig8a_joins.replay_row(n, (pname,))
    assert row["window1_s"] == pytest.approx(row["serial_s"], rel=1e-12)
    assert row["window2_s"] < row["window1_s"]
