"""One analyst in a closed loop: ``scan(T) → group-by sum``.

T holds the configuration's N tuples, keys uniform in [0, key_range) and
values 1, drawn on the device from the seed (the draw of
``repro_torch.bench.fig8b_agg.table``).  Each query aggregates into one
of the mix's group counts, in seeded blocks that hold each count once,
by the planner's choice.  A query is timed from issue until the facade
returns it, its table complete on the device.  The answers of a seeded
sample of each count's queries (a reservoir) are kept for the check.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from nambench import draw
from nambench.reference import olap as reference

M32 = 0xFFFFFFFF
WARMUP_PER_KIND = 1  # unmeasured queries of each group count
SAMPLE_PER_KIND = 2  # answers of each group count kept for the check


def setup(config: dict, traffic: dict, seed: int, device):
    from repro_torch.db import Database
    n = int(config["tuples_per_node"])
    gen = torch.Generator(device=device).manual_seed(draw.seed_words(seed))
    keys = torch.randint(0, int(config["key_range"]), (n,), generator=gen,
                         device=device, dtype=torch.int32)
    vals = torch.ones((n,), dtype=torch.int32, device=device)
    db = Database(device=device)
    db.load_table("T", keys, vals)
    groups = [int(g) for g in traffic["groups"]]
    st = SimpleNamespace(
        db=db, n=n, keys=keys, vals=vals, groups=groups,
        plans=[db.scan("T").aggregate(groups=g) for g in groups],
        order=draw.Blocks(len(groups), seed),
        rng=np.random.default_rng([int(seed), 1]),
        done=[], seen=[0] * len(groups), kept=[[] for _ in groups])
    for i in range(len(groups) * WARMUP_PER_KIND):
        _execute(st, i % len(groups))
    return st


def _execute(st, i: int):
    t0 = time.perf_counter()
    with record_function("nambench.execute"):
        res = st.db.execute(st.plans[i])
    latency = time.perf_counter() - t0
    stats = res.stats
    return res, {
        "attempted": 1, "failed": 0, "latency_s": latency,
        "elapsed_s": res.elapsed_s, "variant": res.variant, "kind": i,
        "groups": st.groups[i], "agg_rows": st.n,
        "route_bytes": stats.get("route", {}).get("bytes", 0),
        "wire_bytes": sum(v.get("bytes", 0) for v in stats.values())}


def unit(st) -> dict:
    i = st.order.next()
    res, rec = _execute(st, i)
    st.done.append(rec)
    # reservoir: each of a count's queries is kept with equal chance
    st.seen[i] += 1
    if len(st.kept[i]) < SAMPLE_PER_KIND:
        st.kept[i].append(res.value)
    else:
        j = int(st.rng.integers(0, st.seen[i]))
        if j < SAMPLE_PER_KIND:
            st.kept[i][j] = res.value
    return rec


def check(st) -> list:
    """The sampled answers group by group against the plain sums; every
    query moved at least its result table through the fabric."""
    st.db = st.plans = None
    gc.collect()
    torch.cuda.empty_cache()
    bad = 0
    for i, g in enumerate(st.groups):
        if not st.kept[i]:
            continue
        want = reference.group_sums(st.keys, st.vals, g)
        for got in st.kept[i]:
            bad += int(((got.to(torch.int64) & M32) != want).sum())
        del want
    return [
        ("group_sum_mismatches", bad, 0),
        ("fabric_short_queries",
         sum(u["wire_bytes"] < 4 * u["groups"] for u in st.done), 0),
    ]
