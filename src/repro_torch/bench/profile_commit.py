"""Where the time of a commit goes on the card.

Two windows, on the card only (it raises without one), each driven by the
bench module that times it:

  fig6   ``rsi.commit`` of the fig6 batch at the paper's width, through
         :func:`repro_torch.bench.fig6_rsi.measured_local_txn_rate`
         (the store restored before each commit), on one shard or, with
         ``--shards n``, on a ``MeshTransport`` of n;
  wave   ``Database.commit`` (``max_retries=2``; 0 on n shards) of one
         wave of §4.3 checkout sessions on a table of 1 KB products,
         through :func:`repro_torch.bench.checkout.drive`.

For each: the commit's time between CUDA events (``event_s``), the
device's own time from ``torch.profiler`` (kernels, copies and fills; one
stream, so they never overlap), the device's busy share (device time over
event time), device operations per commit, and the device time by kernel
name.  The event times come from runs without the profiler.  The wave's
host time by function comes from ``cProfile`` (which slows Python code:
read it as shares; on n shards it sees shard 0's thread, whose waits for
its turn are the other shards' time).  Each of the wave's three
measurements commits a wave of its own, after a warm-up wave.

    PYTHONPATH=src python -m repro_torch.bench.profile_commit [--T 8192] [--shards 4]

Prints one JSON line per window.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import pstats

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch._bits import resolve_device
from repro_torch.bench import checkout, fig6_rsi
from repro_torch.kernels import cas_lock, grouped_agg, radix_partition

PORT_KERNELS = tuple(name for mod in (radix_partition, cas_lock, grouped_agg)
                     for names in mod.KERNELS.values() for name in names)


def _short(name: str) -> str:
    """A device operation's name without its return type, namespace,
    template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip()


def device_summary(prof, commits: int) -> dict:
    """Per-commit device seconds, operations and time by kernel name of
    the profiled window (``commits`` commits)."""
    by_name: dict = {}
    for e in prof.events():
        # a scheduled profiler's step is a range on the device's timeline,
        # not an operation: counting it would count the step's work twice
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("ProfilerStep")):
            continue
        name = _short(e.name)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e.time_range.elapsed_us())
    total_us = sum(us for _, us in by_name.values())
    port_us = sum(us for k, (_, us) in by_name.items()
                  if k.split("::")[-1] in PORT_KERNELS)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "device_s": total_us / 1e6 / commits,
        "port_kernels_s": port_us / 1e6 / commits,
        "device_ops": sum(n for n, _ in by_name.values()) / commits,
        "by_kernel": [{"name": k, "per_commit": n / commits,
                       "ms_per_commit": us / 1e3 / commits}
                      for k, (n, us) in rows[:15]],
    }


@contextlib.contextmanager
def _profiled(out: list):
    """A torch.profiler window; appends its device summary to ``out``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    out.append(device_summary(prof, 1))


@contextlib.contextmanager
def _cprofiled(out: list):
    """A cProfile window; appends its host summary to ``out``."""
    pr = cProfile.Profile()
    pr.enable()
    yield
    torch.cuda.synchronize()
    pr.disable()
    out.append(host_summary(pr))


@contextlib.contextmanager
def _events(out: list):
    """A CUDA-event window; appends its seconds to ``out``."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    yield
    b.record()
    torch.cuda.synchronize()
    out.append(a.elapsed_time(b) / 1e3)


def profile_fig6(T: int = 8192, iters: int = 5, impl=None,
                 shards: int = 1) -> dict:
    """Event times from one run, the device summaries from a second under
    the profiler (one window per commit, the restores outside it)."""
    dev = resolve_device(None)                 # the card, or raise
    kw = dict(fig6_rsi.paper_width(T), iters=iters, device=dev, impl=impl,
              shards=shards)
    timed = fig6_rsi.measured_local_txn_rate(**kw)
    sums: list = []
    fig6_rsi.measured_local_txn_rate(around=lambda: _profiled(sums), **kw)
    sums = sums[1:]                            # the first is the warm-up
    dsum = sorted(sums, key=lambda d: d["device_s"])[len(sums) // 2]
    return {"window": "fig6", "T": T, "impl": impl or "kernel",
            "shards": shards, "event_s": timed["median_s"],
            "host_s": timed["host_median_s"], "times_s": timed["times_s"],
            "device_s_each": [d["device_s"] for d in sums], **dsum,
            "busy_share": dsum["device_s"] / timed["median_s"]}


def profile_wave(T: int = 4096, products: int = checkout.PRODUCTS,
                 payload_words: int = checkout.PAYLOAD_WORDS,
                 seed: int = 7, shards: int = 1) -> dict:
    dev = resolve_device(None)                 # the card, or raise
    waves = checkout.plan(seed=seed, waves=4, T=T, products=products,
                          payload_words=payload_words)
    db = checkout.database(shards, device=dev)
    checkout.create_table(db, products=products, waves=4, T=T,
                          payload_words=payload_words)
    retries = 2 if shards == 1 else 0
    # wave 0 warms up; 1 is timed; 2 under torch.profiler; 3 under cProfile
    ev, dev_sums, host_sums = [], [], []
    checkout.drive(db, waves[:1], max_retries=retries)
    _, _, (host_s,) = checkout.drive(db, waves[1:2], max_retries=retries,
                                     around=lambda: _events(ev))
    checkout.drive(db, waves[2:3], max_retries=retries,
                   around=lambda: _profiled(dev_sums))
    checkout.drive(db, waves[3:4], max_retries=retries,
                   around=lambda: _cprofiled(host_sums))
    return {"window": "wave", "T": T, "shards": shards, "products": products,
            "payload_words": payload_words, "host_s": host_s,
            "event_s": ev[0], **dev_sums[0],
            "busy_share": dev_sums[0]["device_s"] / ev[0],
            "host_by_function": host_sums[0],
            "txn_stats": dict(db.txn_stats)}


def host_summary(pr, top: int = 15) -> dict:
    """The port's functions by cumulative host time, and the heaviest
    functions of any module by own time."""
    st = pstats.Stats(pr)
    total = max(st.total_tt, 1e-12)
    rows = []
    for (path, line, fn), (_, ncalls, tt, ct, _) in st.stats.items():
        where = path.split("src/", 1)[-1] if "repro_torch" in path else path
        rows.append({"fn": f"{where}:{line}({fn})", "calls": ncalls,
                     "own_share": tt / total, "cum_share": ct / total,
                     "port": "repro_torch" in path})
    port = sorted((r for r in rows if r["port"]),
                  key=lambda r: -r["cum_share"])[:top]
    own = sorted(rows, key=lambda r: -r["own_share"])[:top]
    return {"total_s": st.total_tt, "port_by_cum": port, "all_by_own": own}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--T", type=int, default=8192,
                    help="fig6 batch size (paper width)")
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    for impl in (None, "plain"):
        print(json.dumps(profile_fig6(args.T, impl=impl,
                                      shards=args.shards)), flush=True)
    print(json.dumps(profile_wave(shards=args.shards)), flush=True)


if __name__ == "__main__":
    main()
