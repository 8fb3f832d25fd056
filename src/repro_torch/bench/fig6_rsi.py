"""Fig 6's measured side in the port: the RSI commit rate of one batch.

The counterpart of ``benchmarks/fig6_rsi.py::_measured_local_txn_rate``:
the TPC-W checkout workload of §4.3 (each txn updates 3 products and
inserts 4 rows, W = 7), committed through ``rsi.commit`` on a
``LocalTransport``, or with ``shards=n`` on a ``MeshTransport`` of n
shards (the store range-sharded, the batch in n blocks of clients).
Inputs come from numpy with a seed.  Every size is a
parameter; the defaults are the JAX benchmark's (100 000 records, 4
payload words, T = 1024, inserts at 90 000 + i mod 9 000).  With those
defaults every record is seeded, the insert rows included, so every txn
fails its insert CAS and the batch times the abort path, exactly as the
JAX benchmark does.  ``paper_width`` gives the §4.3 store: 1 000 000
seeded products of 256 words (1 KB records) and 4T unborn insert rows.

Timing: the store is restored from a saved copy before each commit,
outside the timed window (the commit updates the store in place), and
each commit is timed with CUDA events on the card, with the host clock on
the CPU; the host clock around the call alone (no sync) gives the time
to issue it.  Run it as a module for one line of JSON::

    PYTHONPATH=src python -m repro_torch.bench.fig6_rsi [--paper] [--T N] [--shards 4]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.configs import OLTP
from repro_torch.core import rsi
from repro_torch.fabric import make_transport


def workload(*, num_records: int = 100_000, payload_words: int = 4,
             T: int = 1024, seeded=None, products=None,
             insert_base: int = 90_000, insert_span: int = 9_000,
             seed: int = 0):
    """(store, txns) as numpy, in the JAX package's dtypes.  Records
    [0, seeded) exist at cid 1; each txn updates 3 products drawn from
    [0, products) under rid 1 and blind-inserts 4 rows at
    insert_base + (i mod insert_span)."""
    seeded = num_records if seeded is None else seeded
    products = num_records if products is None else products
    rng = np.random.default_rng(seed)
    words = np.zeros((num_records,), np.uint32)
    words[:seeded] = 1
    cids = np.zeros((num_records, 1), np.uint32)
    cids[:seeded, 0] = 1
    store = {"words": words,
             "payload": np.zeros((num_records, 1, payload_words), np.uint32),
             "cids": cids,
             "bitvec": np.zeros((60_000,), bool)}
    prods = rng.integers(0, products, (T, 3))
    inserts = insert_base + np.arange(T * 4).reshape(T, 4) % insert_span
    txns = {"write_recs": np.concatenate([prods, inserts], 1).astype(np.int32),
            "read_cids": np.concatenate([np.ones((T, 3), np.uint32),
                                         np.zeros((T, 4), np.uint32)], 1),
            "new_payload": np.ones((T, 7, payload_words), np.uint32),
            "cid": (2 + np.arange(T)).astype(np.uint32)}
    return store, txns


def paper_width(T: int) -> dict:
    """Workload arguments of the §4.3 store at batch size T."""
    n = OLTP.num_products
    return {"num_records": n + 4 * T, "payload_words": OLTP.record_bytes // 4,
            "T": T, "seeded": n, "products": n, "insert_base": n,
            "insert_span": 4 * T}


def measured_local_txn_rate(*, iters: int = 5, device=None, impl=None,
                            around=None, shards: int = 1,
                            **workload_kw) -> dict:
    """Commit one batch ``iters`` times from the same store (restored
    outside the timed window), on one shard or on ``shards``.  Returns
    txn/s from the median commit, the per-commit times, the host time to
    issue each commit, the committed count and the per-verb counters of
    one commit (one transport, its counters reset before each commit, as
    a database keeps one transport and its shard threads; every commit
    must count the same).  ``around()``, if given, makes a context manager entered around
    each timed commit (a profiler window)."""
    dev = resolve_device(device)
    store_np, txns_np = workload(**workload_kw)
    saved = rsi.store_from_numpy(store_np, dev)
    live = {k: v.clone() for k, v in saved.items()}
    txns = rsi.TxnBatch.from_numpy(device=dev, **txns_np)
    T = txns_np["cid"].shape[0]
    times, host, stats, committed = [], [], None, None
    transport = make_transport(shards, device=dev, impl=impl)
    for _ in range(iters + 1):                 # the first is the warm-up
        for k in live:
            live[k].copy_(saved[k])
        transport.reset_stats()
        with (around() if around else contextlib.nullcontext()):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                ok, _ = rsi.commit(live, txns, transport=transport)
                host.append(time.perf_counter() - t0)
                end.record()
                torch.cuda.synchronize(dev)
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                ok, _ = rsi.commit(live, txns, transport=transport)
                host.append(time.perf_counter() - t0)
                times.append(host[-1])
        n_ok = int(ok.sum())
        if stats is None:
            stats, committed = transport.stats(), n_ok
            plan_builds = transport.plan_builds
        elif transport.stats() != stats or n_ok != committed:
            raise RuntimeError("fig6: a repeated commit counted or "
                               "committed differently")
    times, host = times[1:], host[1:]
    median = statistics.median(times)
    return {"T": T, "shards": shards, "txn_per_s": T / median,
            "median_s": median, "times_s": times, "spread": spread(times),
            "host_median_s": statistics.median(host), "host_times_s": host,
            "committed": committed, "stats": stats,
            "plan_builds": plan_builds, "device": str(dev),
            "workload": {k: v for k, v in workload_kw.items()}}


def spread(times) -> dict:
    """Min, quartiles and max of a list of times, and the interquartile
    range over the median: how far one reading strays inside one run."""
    q1, q2, q3 = statistics.quantiles(times, n=4) if len(times) > 1 \
        else (times[0],) * 3
    return {"min": min(times), "q1": q1, "median": q2, "q3": q3,
            "max": max(times), "iqr_over_median": (q3 - q1) / q2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paper", action="store_true",
                    help="the §4.3 store (1M products of 1 KB)")
    ap.add_argument("--T", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args(argv)
    kw = paper_width(args.T) if args.paper else {"T": args.T}
    print(json.dumps(measured_local_txn_rate(iters=args.iters,
                                             device=args.device,
                                             shards=args.shards, **kw)))


if __name__ == "__main__":
    main()
