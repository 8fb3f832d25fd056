"""Fig 8(a) in the port: the four distributed joins through the facade.

The counterpart of ``benchmarks/fig8a_joins.py``.  R and S hold N tuples
each (the paper's §5.4 deployment: N = 128 000 000 per node, 8 B tuples;
``configs/paper_nam.py::OLAP``), loaded into a ``Database`` with hash
partitioning.  For each bloom selectivity the query is ONE logical plan,
``scan(R).join(scan(S).filter(sel)).aggregate()``: the planner's choice
comes from ``explain`` per network profile, then every variant of
``JOIN_VARIANTS`` is forced, executed a warm-up and some timed times, and
held to the ground truth with no dropped rows.  Optionally the same
queries run on a second database whose kernels run their plain versions,
which must give the same value, drop count and counters.  ``shards=n``
runs the same relations over a ``MeshTransport`` of n shards (each shard
a block of N/n rows of each relation).

The relations come from ``seed`` through a ``torch.Generator`` on the
device (the JAX PRNG is not portable): R's keys are a permutation of
1..N with ``rv = rk``; a ``sel`` fraction of S's keys hit R (uniform in
1..N), the rest miss (uniform in N+1..2N-1); ``sv = 1``.  So the join
aggregate is the u32 sum of the S keys that are <= N: the independent
ground truth.

The shuffle microbench routes one (keys, vals) relation of N rows, the
motion inside every join, with ``overlap`` on and off.  A
``LocalTransport`` has no wire for the overlap to hide, so unlike the JAX
benchmark nothing asserts that it wins.  The two legs also differ in how
they pack: the overlap leg gathers through the inverted plan in plain
torch and launches no scatter kernel, the other runs the scatter kernel.
:func:`route_replay_pricing` prices the double-buffered route schedule
on the contention simulator, as the JAX benchmark's ``replay`` row does.

:func:`joins` runs the queries alone, :func:`shuffle_route_bench` one
leg of the microbench, and :func:`run` the whole figure.  :func:`figure`
is the figure in the harness's form, at the JAX benchmark's N = 2**20:
its rows and extras are the JAX benchmark's (the planner's pick per
selectivity and profile, the crossover, the forced grid, the shuffle
route's pair, the modeled wire), timed the harness's way
(``bench/timing.py``).

    PYTHONPATH=src python -m repro_torch.bench.fig8a_joins --n 1048576 [--shards 4]
    PYTHONPATH=src python -m repro_torch.bench.run --only fig8a [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch._bits import M32, np_u32, resolve_device, u32
from repro_torch.bench import queries, timing
from repro_torch.db import JOIN_VARIANTS, Database
from repro_torch.fabric import LocalTransport, make_transport, netsim, sim

SELS = (0.25, 0.5, 0.75, 1.0)
DEFAULT_PROFILES = ("rdma_fdr4x",)       # the paper's measured cluster
ROUTE_CHUNKS = 4                         # double-buffer depth for the A/B


def relations(sel: float, n: int, *, seed: int = 0, device=None):
    """(rk, rv, sk, sv) int32 bit patterns of N rows each on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + int(sel * 100))
    rk = (torch.randperm(n, generator=g, device=dev) + 1).to(torch.int32)
    hits = torch.randint(1, n + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    miss = torch.randint(n + 1, 2 * n, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    take = torch.rand((n,), generator=g, device=dev) < sel
    sk = torch.where(take, hits, miss)
    return rk, rk, sk, torch.ones((n,), dtype=torch.int32, device=dev)


def ground_truth(sk: torch.Tensor, n: int) -> int:
    """The join aggregate of :func:`relations`: the u32 sum of S's keys
    that R holds (1..N), each times rv = key and sv = 1."""
    k = u32(sk)
    return int(torch.where(k <= n, k, 0).sum()) & M32


def _route_leg(n_rows: int, dev, *, overlap: bool, chunks: int, seed: int):
    """One leg of the shuffle microbench as a call: a routed exchange of a
    (keys, vals) relation of ``n_rows`` on a fresh transport, so no join's
    counters move."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ks = torch.randint(0, 1 << 30, (n_rows,), generator=g, device=dev,
                       dtype=torch.int32)
    vs = torch.ones((n_rows,), dtype=torch.int32, device=dev)
    transport = LocalTransport(device=dev)
    n = transport.n
    cap = 2 * n_rows // n
    dest = (ks % n).to(torch.int32)

    def once():
        res = transport.route({"k": ks, "v": vs}, dest, cap=cap,
                              chunks=chunks, overlap=overlap)
        return res.fields["k"], res.fields["v"], res.dropped

    return once


def shuffle_route_bench(n_rows: int, *, device=None, overlap: bool = False,
                        chunks: int = 1, seed: int = 0) -> float:
    """Median seconds of 3 single routed exchanges of a (keys, vals) relation:
    the motion ``_route_by_key`` performs inside every join, without the
    local join work."""
    dev = resolve_device(device)
    once = _route_leg(n_rows, dev, overlap=overlap, chunks=chunks, seed=seed)
    once()                                               # warm-up
    return statistics.median(queries.time_call(once, dev)[1]
                             for _ in range(3))


def route_replay_pricing(profile_name: str, n: int, cap: int,
                         chunks: int, row_words: int = 3) -> dict:
    """Price the double-buffered route schedule on the contention
    simulator: per chunk, a pack (compute) event then the chunk's wire
    event, the pack sized to the chunk's wire time.  ``window=1`` replays
    the synchronous schedule and lands on the analytic serial sum;
    ``window=2`` is the double-buffered one, and the gap is the modeled
    value of the overlap on this profile."""
    p = netsim.get_profile(profile_name)
    nbytes = n * cap * 4 * row_words / chunks
    wire_s = p.t_call(n, nbytes)
    tr = sim.EventTracer()
    for _ in range(chunks):
        tr.emit_compute(wire_s)
        tr.emit("route", n, nbytes, collective=True)
    serial = sim.analytic_time(tr.events, p)
    nodes = max(2, n)
    sync = sim.replay(tr.events, p, nodes=nodes, window=1).makespan
    over = sim.replay(tr.events, p, nodes=nodes, window=2).makespan
    return {"profile": p.name, "chunks": chunks, "serial_s": serial,
            "window1_s": sync, "window2_s": over,
            "overlap_speedup": serial / over if over else 0.0}


def joins(n: int, *, device=None, seed: int = 0, sels=SELS,
          profiles=DEFAULT_PROFILES, warmup: int = 1, timed: int = 3,
          plain_sels=(), plain_variants=JOIN_VARIANTS, profile_sels=(),
          shards: int = 1) -> dict:
    """The figure's queries at N rows a relation (on ``shards`` shards),
    through the facade and nothing else.  Raises if a join misses its
    ground truth, drops a row, or differs from the plain path on
    ``plain_sels`` (for ``plain_variants``).  ``profile_sels`` adds one
    profiled execution per variant (card only).  Returns JSON-ready
    rows."""
    dev = resolve_device(device)
    db = Database(make_transport(shards, device=dev), net=profiles[0])
    plain = Database(make_transport(shards, device=dev, impl="plain"),
                     net=profiles[0]) if plain_sels else None
    for d in (db, plain) if plain else (db,):
        d.create_table("R", n, payload_words=1, partitioning="hash")
        d.create_table("S", n, payload_words=1, partitioning="hash")
    rows = []
    for sel in sels:
        rk, rv, sk, sv = relations(sel, n, seed=seed, device=dev)
        truth = ground_truth(sk, n)
        db.table("R").load(rk, rv)
        db.table("S").load(sk, sv)
        if sel in plain_sels:
            plain.table("R").load(rk, rv)
            plain.table("S").load(sk, sv)
        del rk, rv, sk, sv
        q = db.scan("R").join(db.scan("S").filter(sel=sel)).aggregate()
        row = {"sel": sel, "truth": truth,
               "planner": queries.planner_rows(db, q, profiles),
               "variants": {}}
        for name in JOIN_VARIANTS:
            r = queries.run_variant(db, q, name, warmup=warmup, timed=timed)
            res = r.pop("result")
            value = int(np_u32(res.value))
            if value != truth or res.dropped != 0:
                raise AssertionError(
                    f"fig8a sel={sel} {name}: value {value} (truth {truth}),"
                    f" dropped {res.dropped}")
            out = {"value": value, "dropped": res.dropped,
                   "stats": res.stats, **r}
            if sel in plain_sels and name in plain_variants:
                out["plain_s"] = queries.check_plain(plain, q, name, res)
            if sel in profile_sels:
                out["profile"] = queries.profiled(db, q, name, r["median_s"])
            row["variants"][name] = out
        rows.append(row)
    stats = db.fabric_stats()
    modeled = {p: netsim.get_profile(p).modeled_time(stats)
               for p in profiles}
    return {"figure": "fig8a", "n": n, "shards": shards, "device": str(dev),
            "rows": rows, "modeled_wire_s": modeled}


def replay_row(n: int, profiles=DEFAULT_PROFILES) -> dict:
    """The figure's ``replay`` row: the microbench's route of N rows (one
    shard, priced on at least 2 nodes, cap 2N/nodes) on the first
    profile, as the JAX benchmark prices it."""
    nodes = 2                  # max(2, shards) for the one shard it routes on
    return route_replay_pricing(profiles[0], nodes, 2 * n // nodes,
                                ROUTE_CHUNKS)


def run(n: int, *, device=None, seed: int = 0, **kw) -> dict:
    """The whole figure: :func:`joins` (``kw`` goes there), then the
    shuffle microbench with overlap on and off and its replay pricing."""
    out = joins(n, device=device, seed=seed, **kw)
    on = shuffle_route_bench(n, device=device, overlap=True,
                             chunks=ROUTE_CHUNKS, seed=seed)
    off = shuffle_route_bench(n, device=device, seed=seed)
    out["shuffle_route"] = {
        "rows": n, "overlap_on_s": on, "overlap_off_s": off,
        "chunks": ROUTE_CHUNKS,
        "replay": replay_row(n, kw.get("profiles", DEFAULT_PROFILES))}
    return out


def planner_rows(db, sel: float, profiles, rows: list):
    """The figure's query at ``sel`` over R and S of ``db``, and its rows
    of the planner's pick per profile (and, over several profiles, the
    crossover row).  Returns (the query, {profile: chosen})."""
    q = db.scan("R").join(db.scan("S").filter(sel=sel)).aggregate()
    winners = queries.explain_rows(db, q, profiles, f"fig8a/sel{sel}", rows)
    if len(profiles) > 1:
        rows.append((f"fig8a/sel{sel}_crossover", 0.0,
                     "|".join(f"{p}:{w}" for p, w in winners.items())))
    return q, winners


def figure(profiles=None, timed=False, *, device=None, n: int = 1 << 20):
    """The figure in the harness's form: (rows, extras) with the JAX
    benchmark's rows and extras at N tuples a relation.  Every forced join
    is held to the ground truth with no dropped row.  The overlap pair is
    reported, not asserted: a ``LocalTransport`` has no wire to hide."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    dev = resolve_device(device)
    rows, measured = [], {}
    db = Database(LocalTransport(device=dev), net=profiles[0])
    db.create_table("R", n, payload_words=1, partitioning="hash")
    db.create_table("S", n, payload_words=1, partitioning="hash")
    crossover = {}
    for sel in SELS:
        rk, rv, sk, sv = relations(sel, n, device=dev)
        truth = ground_truth(sk, n)
        db.table("R").load(rk, rv)
        db.table("S").load(sk, sv)
        del rk, rv, sk, sv
        q, crossover[sel] = planner_rows(db, sel, profiles, rows)

        def check(res, sel=sel, truth=truth):
            value = int(np_u32(res.value))
            if value != truth or res.dropped != 0:
                raise AssertionError(f"fig8a sel={sel}: value {value} "
                                     f"(truth {truth}), dropped "
                                     f"{res.dropped}")

        base = None
        for name in JOIN_VARIANTS:              # forced grid for the figure
            us = queries.grid_us(db, q, name, timed=timed,
                                 measured=measured,
                                 name=f"fig8a/sel{sel}_{name}", check=check)
            if name == "ghj":
                base = us
            rows.append((f"fig8a/sel{sel}_{name}", us,
                         f"{base/us:.2f}x_vs_GHJ" if base else ""))
    if len(profiles) > 1:
        # the join-variant argmin must differ on >= 2 profiles
        assert any(len(set(w.values())) > 1 for w in crossover.values()), \
            f"no join-variant crossover across {profiles}"
    # the shuffle microbench, overlap on (4 chunks) and off, each on a
    # fresh transport so the counters price only the joins' traffic
    on_s, off_s = (timing.device_time_s(
        _route_leg(n, dev, overlap=ov, chunks=ch, seed=0), device=dev)
        for ov, ch in ((True, ROUTE_CHUNKS), (False, 1)))
    rows.append(("fig8a/shuffle_route_1M", on_s * 1e6,
                 f"overlap_on_chunks{ROUTE_CHUNKS}"))
    rows.append(("fig8a/shuffle_route_1M_overlap_off", off_s * 1e6,
                 f"{off_s / on_s:.2f}x_slower_sync"))
    measured["fig8a/shuffle_route_1M"] = on_s
    measured["fig8a/shuffle_route_1M_overlap_off"] = off_s
    overlap = {"on_s": on_s, "off_s": off_s, "chunks": ROUTE_CHUNKS,
               "replay": replay_row(n, profiles)}
    stats = db.fabric_stats()
    modeled = {p: netsim.get_profile(p).modeled_time(stats)
               for p in profiles}
    for pname, s in modeled.items():
        rows.append((f"fig8a/modeled_wire_{pname}", s * 1e6,
                     "all_counted_traffic"))
    extras = {"fabric": stats, "modeled_wire_s": modeled,
              "overlap": overlap,
              "crossover": {str(s): w for s, w in crossover.items()}}
    if timed:
        extras["measured_s"] = measured
    return rows, extras


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="tuples per relation (the paper: 128000000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, device=args.device, seed=args.seed,
                         shards=args.shards)))


if __name__ == "__main__":
    main()
