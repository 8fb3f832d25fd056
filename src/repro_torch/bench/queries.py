"""Driving OLAP queries through the facade for the Fig 8 benchmarks.

Shared by :mod:`repro_torch.bench.fig8a_joins` and
:mod:`repro_torch.bench.fig8b_agg`: the planner's rows for a plan, a
forced variant executed a warm-up and some timed times (each between CUDA
events on the card, on the host clock on the CPU) with every execution
held to the same value, drop count and counters, the same query on a
second database whose kernels run their plain versions, and one execution
under ``torch.profiler``.  :func:`explain_rows` and :func:`grid_us` give
the JAX harness's rows of a figure: the planner's pick per profile and a
forced variant's time.
"""
from __future__ import annotations

import statistics
import time

import torch

from repro_torch.bench import timing
from repro_torch.kernels import ops


def time_call(fn, device: torch.device):
    """(fn(), seconds): between CUDA events on the card, on the host clock
    after the call on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(device)
    return out, a.elapsed_time(b) / 1e3


def planner_rows(db, q, profiles) -> dict:
    """{profile: {chosen, alternatives}} of ``db.explain`` per profile."""
    out = {}
    for p in profiles:
        ex = db.explain(q, profile=p)
        out[p] = {"chosen": ex.chosen,
                  "alternatives": [{"name": a.name, "cost_s": a.cost_s,
                                    "feasible": a.feasible}
                                   for a in ex.alternatives]}
    return out


def explain_rows(db, q, profiles, prefix: str, rows: list) -> dict:
    """Append one row a profile, ``{prefix}_planner_{profile}``, derived
    ``picked_<chosen>_<name>:<cost ms>|...`` as the JAX harness prints
    ``db.explain``; returns {profile: chosen}."""
    winners = {}
    for pname in profiles:
        ex = db.explain(q, profile=pname)
        winners[pname] = ex.chosen
        costs = "|".join(f"{a.name}:{a.cost_s * 1e3:.1f}ms"
                         for a in ex.alternatives)
        rows.append((f"{prefix}_planner_{pname}", 0.0,
                     f"picked_{ex.chosen}_{costs}"))
    return winners


def grid_us(db, q, variant: str, *, timed: bool, measured: dict,
            name: str, check=None) -> float:
    """Microseconds of one forced execution, the JAX harness's way: under
    ``timed`` the median of 3 after a warm-up (``timing.device_time_s``,
    also recorded in ``measured[name]``), else the mean of 3.  A first
    execution comes before either, held by ``check(result)`` if given."""
    dev = db.device
    first = db.execute(q, force_variant=variant)
    if check is not None:
        check(first)
    if timed:
        s = timing.device_time_s(
            lambda: db.execute(q, force_variant=variant).value,
            warmup=1, k=3, device=dev)
        measured[name] = s
        return s * 1e6
    timing.sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        db.execute(q, force_variant=variant)
    timing.sync(dev)
    return (time.perf_counter() - t0) / 3 * 1e6


def _counters(stats: dict) -> dict:
    """A stats delta without ``peak_outstanding``: that is the transport's
    high-water mark over its whole history, not the query's own."""
    return {verb: {k: v for k, v in s.items() if k != "peak_outstanding"}
            for verb, s in stats.items()}


def _same(a, b) -> bool:
    return (torch.equal(a.value, b.value) and a.dropped == b.dropped
            and _counters(a.stats) == _counters(b.stats))


def run_variant(db, q, variant: str, *, warmup: int = 1,
                timed: int = 3) -> dict:
    """Execute ``q`` forced to ``variant``: ``warmup`` untimed, then
    ``timed`` timed executions.  Every execution must give the same value,
    drop count and counters.  Returns the first result (``result``), the
    timed seconds with their median, min and max, and the peak device
    bytes allocated over the runs (``None`` on the CPU)."""
    dev = db.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first, times = None, []
    for k in range(warmup + timed):
        res, secs = time_call(lambda: db.execute(q, force_variant=variant),
                              dev)
        if first is None:
            first = res
        elif not _same(first, res):
            raise AssertionError(f"{variant}: a repeated execution gave "
                                 "another value, drop count or counters")
        if k >= warmup:
            times.append(secs)
    return {"result": first, "times_s": times,
            "median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def check_plain(plain_db, q, variant: str, want) -> float:
    """Run ``q`` once on ``plain_db`` (``impl="plain"``) and hold it to
    ``want`` (a QueryResult of the kernels' database): the same value,
    drop count and counters (bar the history-wide ``peak_outstanding``),
    and no kernel launched.  Returns its seconds."""
    before = ops.launch_counts()
    res, secs = time_call(
        lambda: plain_db.execute(q, force_variant=variant), plain_db.device)
    if ops.launch_counts() != before:
        raise AssertionError(f"{variant}: the plain run launched a kernel")
    if not _same(res, want):
        raise AssertionError(f"{variant}: the plain path differs from the "
                             "kernels' path")
    return secs


def profiled(db, q, variant: str, event_s: float) -> dict:
    """One execution under ``torch.profiler`` (card only): device seconds,
    operations and time by kernel, and the device's busy share of
    ``event_s`` (the execution's time between CUDA events, measured
    without the profiler).  A first execution warms the tracer up and is
    not recorded: a fresh trace can miss the first kernels it sees."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.bench.profile_commit import device_summary
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            db.execute(q, force_variant=variant)
            torch.cuda.synchronize(db.device)
            prof.step()
    summary = device_summary(prof, 1)
    return {**summary, "busy_share": summary["device_s"] / event_s}
