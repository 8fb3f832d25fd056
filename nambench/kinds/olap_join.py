"""One analyst in a closed loop: ``scan(R) ⋈ scan(S_sel) → sum``.

R holds the configuration's N tuples (keys a permutation of 1..N, values
equal to the keys); one S of N tuples for each selectivity of the mix
(a ``sel`` share of its keys uniform in 1..N, the rest uniform in
N+1..2N-1, values 1), all drawn on the device from the seed (the draw of
``repro_torch.bench.fig8a_joins.relations``).  Each query is the
planner's choice on the facade's default ``Database``; the selectivities
come in seeded blocks that hold each one once.  A query is timed from
issue until its value is on the host.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from nambench import draw
from nambench.reference import olap as reference

M32 = 0xFFFFFFFF
LANES = 2            # a routed (key, value) row: two 32-bit lanes
WARMUP_PER_KIND = 1  # unmeasured queries of each selectivity


def relations(n: int, sels, gen, device):
    """(rk, [sk for each sel], ones) as int32 bit patterns."""
    rk = (torch.randperm(n, generator=gen, device=device) + 1).to(
        torch.int32)
    sks = []
    for sel in sels:
        hits = torch.randint(1, n + 1, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        miss = torch.randint(n + 1, 2 * n, (n,), generator=gen,
                             device=device, dtype=torch.int32)
        take = torch.rand((n,), generator=gen, device=device) < sel
        sks.append(torch.where(take, hits, miss))
        del hits, miss, take
    return rk, sks, torch.ones((n,), dtype=torch.int32, device=device)


def setup(config: dict, traffic: dict, seed: int, device):
    from repro_torch.db import Database
    n = int(config["tuples_per_node"])
    sels = [float(s) for s in traffic["sels"]]
    gen = torch.Generator(device=device).manual_seed(draw.seed_words(seed))
    rk, sks, ones = relations(n, sels, gen, device)
    db = Database(device=device)
    db.load_table("R", rk, rk)
    for i, sk in enumerate(sks):
        db.load_table(f"S{i}", sk, ones)
    plans = [db.scan("R").join(db.scan(f"S{i}").filter(sel=sel)).aggregate()
             for i, sel in enumerate(sels)]
    st = SimpleNamespace(
        db=db, n=n, sels=sels, rk=rk, sks=sks, ones=ones, plans=plans,
        order=draw.Blocks(len(sels), seed), done=[])
    for i in range(len(sels) * WARMUP_PER_KIND):
        _execute(st, i % len(sels))
    return st


def _execute(st, i: int) -> dict:
    t0 = time.perf_counter()
    with record_function("nambench.execute"):
        res = st.db.execute(st.plans[i])
        value = int(res.value) & M32
    latency = time.perf_counter() - t0
    stats = res.stats
    return {"attempted": 1, "failed": 0, "latency_s": latency,
            "elapsed_s": res.elapsed_s, "variant": res.variant, "kind": i,
            "value": value, "dropped": res.dropped,
            "route_bytes": stats.get("route", {}).get("bytes", 0),
            "wire_bytes": sum(v.get("bytes", 0) for v in stats.values()),
            "route_rows": [st.n, st.n], "route_lanes": LANES}


def unit(st) -> dict:
    rec = _execute(st, st.order.next())
    st.done.append(rec)
    return rec


def check(st) -> list:
    """Every query of the window against the plain join of its relations;
    no row dropped; each route carried both relations' rows."""
    st.db = st.plans = None
    gc.collect()
    torch.cuda.empty_cache()
    want = [reference.join_sum(st.rk, st.rk, sk, st.ones) for sk in st.sks]
    need = sum(rows * (LANES + 1) * 4 for rows in (st.n, st.n))
    return [
        ("join_value_mismatches",
         sum(u["value"] != want[u["kind"]] for u in st.done), 0),
        ("dropped_rows", sum(int(u["dropped"] or 0) for u in st.done), 0),
        ("route_short_queries",
         sum(u["route_bytes"] < need for u in st.done), 0),
    ]
