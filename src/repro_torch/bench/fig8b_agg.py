"""Fig 8(b) in the port: Dist-AGG vs RDMA-AGG over distinct group counts.

The counterpart of ``benchmarks/fig8b_agg.py``.  T holds N tuples (the
paper's §5.4 deployment: N = 128 000 000 per node), loaded into a
``Database``.  For each group count of ``OLAP.distinct_groups_sweep``
(1 ... 67 108 864) the query is ``scan(T).aggregate(groups=G)``: the
planner's choice comes from ``explain`` per network profile, then both
schemes are forced, executed a warm-up and some timed times, and held to
the ground truth and to each other.  Optionally the same queries run on a
second database whose kernels run their plain versions.  ``shards=n``
runs the same table over a ``MeshTransport`` of n shards (each a block of
N/n rows).

The table comes from ``seed`` through a ``torch.Generator`` on the device:
keys uniform in [0, 2**30), vals = 1.  So each group's sum is its count,
``bincount(keys % G)``: the independent ground truth.

The kernel row times the grouped-aggregation kernel's own function
(``ops.grouped_agg``, f32) on the table's rows into 2048 slots, as the
JAX benchmark's kernel row does, and holds it bit for bit to the counts
(integers below 2**24 a slot are exact in f32).  It calls the kernel
directly, not through the facade.

:func:`aggregations` runs the queries alone, :func:`kernel_row` the
kernel row, and :func:`run` the whole figure.  :func:`figure` is the
figure in the harness's form, at the JAX benchmark's N = 2**20 and group
counts (1, 64, 4096, 262 144): its rows and extras are the JAX
benchmark's, timed the harness's way (``bench/timing.py``).

    PYTHONPATH=src python -m repro_torch.bench.fig8b_agg --n 1048576 [--shards 4]
    PYTHONPATH=src python -m repro_torch.bench.run --only fig8b [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch._bits import resolve_device, to_i32, u32
from repro_torch.bench import queries, timing
from repro_torch.configs import OLAP
from repro_torch.db import AGG_VARIANTS, Database
from repro_torch.fabric import make_transport, netsim
from repro_torch.kernels import ops

GROUPS = OLAP.distinct_groups_sweep
FIGURE_GROUPS = (1, 64, 4096, 262_144)   # the JAX benchmark's, at N = 2**20
DEFAULT_PROFILES = ("rdma_fdr4x",)
KERNEL_SLOTS = 2048


def table(n: int, *, seed: int = 0, device=None):
    """(keys, vals) int32 bit patterns of N rows on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 1 << 30, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    return keys, torch.ones((n,), dtype=torch.int32, device=dev)


def ground_truth(keys: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-group counts of ``keys % groups`` as u32 bit patterns: the sums
    of :func:`table`'s unit values."""
    return to_i32(torch.bincount(u32(keys) % groups, minlength=groups))


def _kernel_inputs(keys, vals, impl=None):
    """The kernel row's (slot, f32 values), after one ``ops.grouped_agg``
    held bit for bit to the counts."""
    slot = (u32(keys) % KERNEL_SLOTS).to(torch.int32)
    fv = vals.to(torch.float32)
    want = torch.bincount(slot.to(torch.int64),
                          minlength=KERNEL_SLOTS).to(torch.float32)
    got = ops.grouped_agg(slot, fv, KERNEL_SLOTS, impl=impl)
    if not torch.equal(got, want):
        raise AssertionError("fig8b kernel row: grouped_agg differs from "
                             "the counts")
    return slot, fv


def kernel_row(keys, vals, *, impl=None, iters: int = 3) -> dict:
    """``ops.grouped_agg`` (f32) of the rows into KERNEL_SLOTS slots,
    timed, and held bit for bit to the counts."""
    dev = keys.device
    slot, fv = _kernel_inputs(keys, vals, impl)
    times = [queries.time_call(lambda: ops.grouped_agg(
        slot, fv, KERNEL_SLOTS, impl=impl), dev)[1] for _ in range(iters)]
    return {"rows": keys.shape[0], "slots": KERNEL_SLOTS,
            "median_s": statistics.median(times), "times_s": times}


def aggregations(keys, vals, *, groups=GROUPS, profiles=DEFAULT_PROFILES,
                 warmup: int = 1, timed: int = 3, plain_groups=(),
                 profile_groups=(), shards: int = 1) -> dict:
    """The figure's queries over the table (``keys``, ``vals``) on
    ``shards`` shards, through the facade and nothing else.  Raises if a scheme misses the ground
    truth, the two schemes differ, or (on ``plain_groups``) the plain path
    differs.  ``profile_groups`` adds one profiled execution per scheme
    (card only).  Returns JSON-ready rows, each with the kernel launches
    of its group count."""
    dev = keys.device
    db = Database(make_transport(shards, device=dev), net=profiles[0])
    db.load_table("T", keys, vals)
    plain = None
    if plain_groups:
        plain = Database(make_transport(shards, device=dev, impl="plain"),
                         net=profiles[0])
        plain.load_table("T", keys, vals)
    rows = []
    for G in groups:
        before = ops.launch_counts()
        truth = ground_truth(keys, G)
        q = db.scan("T").aggregate(groups=G)
        row = {"groups": G, "planner": queries.planner_rows(db, q, profiles),
               "schemes": {}}
        for name in AGG_VARIANTS:
            r = queries.run_variant(db, q, name, warmup=warmup, timed=timed)
            res = r.pop("result")
            if not torch.equal(res.value, truth):
                raise AssertionError(f"fig8b groups={G} {name}: the sums "
                                     "differ from bincount(keys % G)")
            out = {"stats": res.stats, **r}
            if G in plain_groups:
                out["plain_s"] = queries.check_plain(plain, q, name, res)
            if G in profile_groups:
                out["profile"] = queries.profiled(db, q, name, r["median_s"])
            row["schemes"][name] = out
        row["launches"] = {k: v - before[k]
                           for k, v in ops.launch_counts().items()
                           if v != before[k]}
        rows.append(row)
        del truth
    stats = db.fabric_stats()
    return {"figure": "fig8b", "n": keys.shape[0], "shards": shards,
            "device": str(dev), "rows": rows,
            "modeled_wire_s": {p: netsim.get_profile(p).modeled_time(stats)
                               for p in profiles}}


def run(n: int, *, device=None, seed: int = 0, **kw) -> dict:
    """The whole figure at N rows: :func:`aggregations` (``kw`` goes
    there), then the kernel row on the same table."""
    keys, vals = table(n, seed=seed, device=device)
    out = aggregations(keys, vals, **kw)
    out["kernel_row"] = kernel_row(keys, vals)
    return out


def planner_rows(db, groups: int, profiles, rows: list):
    """The figure's query at ``groups`` over T of ``db``, and its rows of
    the planner's pick per profile (and, over several profiles, the
    crossover row).  Returns (the query, {profile: chosen})."""
    q = db.scan("T").aggregate(groups=groups)
    winners = queries.explain_rows(db, q, profiles,
                                   f"fig8b/groups{groups}", rows)
    if len(profiles) > 1:
        rows.append((f"fig8b/groups{groups}_crossover", 0.0,
                     "|".join(f"{p}:{w}" for p, w in winners.items())))
    return q, winners


def figure(profiles=None, timed=False, *, device=None, n: int = 1 << 20):
    """The figure in the harness's form: (rows, extras) with the JAX
    benchmark's rows and extras at N tuples.  Every forced aggregation is
    held to the ground truth; the kernel row is the f32 ``grouped_agg``
    entry on the card (its plain version on the CPU), held to the
    counts."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    dev = resolve_device(device)
    rows, measured = [], {}
    db = Database(make_transport(1, device=dev), net=profiles[0])
    keys, vals = table(n, device=dev)
    db.load_table("T", keys, vals)
    crossover = {}
    for G in FIGURE_GROUPS:
        q, crossover[G] = planner_rows(db, G, profiles, rows)
        truth = ground_truth(keys, G)

        def check(res, G=G, truth=truth):
            if not torch.equal(res.value, truth):
                raise AssertionError(f"fig8b groups={G}: the sums differ "
                                     "from bincount(keys % G)")

        for name in AGG_VARIANTS:               # forced grid for the figure
            us = queries.grid_us(db, q, name, timed=timed,
                                 measured=measured,
                                 name=f"fig8b/groups{G}_{name}", check=check)
            rows.append((f"fig8b/groups{G}_{name}", us, ""))
    if len(profiles) > 1:
        # the agg-scheme argmin must differ somewhere along the axis
        assert any(len(set(w.values())) > 1 for w in crossover.values()), \
            f"no agg-scheme crossover across {profiles}"
    # kernel-level pre-aggregation (phase 1 hot loop)
    slot, fv = _kernel_inputs(keys, vals)
    timing.sync(dev)
    t0 = time.perf_counter()
    ops.grouped_agg(slot, fv, KERNEL_SLOTS)
    timing.sync(dev)
    rows.append((f"fig8b/kernel_grouped_agg_1M_{KERNEL_SLOTS}slots",
                 (time.perf_counter() - t0) * 1e6,
                 "cuda_kernel" if dev.type == "cuda" else "plain_torch"))
    if timed:
        measured[f"fig8b/kernel_grouped_agg_1M_{KERNEL_SLOTS}slots"] = \
            timing.device_time_s(
                lambda: ops.grouped_agg(slot, fv, KERNEL_SLOTS), device=dev)
    stats = db.fabric_stats()
    modeled = {p: netsim.get_profile(p).modeled_time(stats)
               for p in profiles}
    extras = {"fabric": stats, "modeled_wire_s": modeled,
              "crossover": {str(g): w for g, w in crossover.items()}}
    if timed:
        extras["measured_s"] = measured
    return rows, extras


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="tuples (the paper: 128000000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, device=args.device, seed=args.seed,
                         shards=args.shards)))


if __name__ == "__main__":
    main()
