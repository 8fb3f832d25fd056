"""The paper's own workload: TPC-W-checkout-style transactions against the
NAM store under RSI (paper §4.3): read 3 products, update 3 stocks, insert
1 order + 3 orderlines; concurrent waves with CAS arbitration.  A twin of
``examples/nam_oltp.py``.

A ``Database`` owns the products table (regions in the NAM pool), the
timestamp oracle (FETCH_ADD on a counter word) and ONE fabric transport
that every verb runs, and is counted, through.  Each checkout is a
``Session``; a wave of sessions commits as one routed prepare/install
round trip (on the card: the rank, scatter and ``cas_lock`` kernels).
The products of each wave are drawn with numpy from seed 0 (the JAX
example draws them with ``jax.random``); :func:`checkout_waves` takes
them as an argument.

  PYTHONPATH=src python -m repro_torch.examples.nam_oltp [--isolation rsi|2pc] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._bits import np_u32, resolve_device
from repro_torch.configs import OLTP
from repro_torch.core import rsi
from repro_torch.db import Database

N_PRODUCTS = 10_000   # scaled-down TPC-W product table
T = 512               # concurrent checkout sessions per wave
WAVES = 8


def draw_products() -> list:
    """Each wave's (T, updates_per_txn) product ids, uniform, from seed
    0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, N_PRODUCTS, (T, OLTP.updates_per_txn))
            for _ in range(WAVES)]


def checkout_waves(db, products, waves, *, order_base: int = N_PRODUCTS,
                   isolation: str = "rsi") -> dict:
    """Commit each wave of ``waves`` (product ids a session) as one
    routed commit; every checkout also inserts an order and 3 lines on
    fresh rows from ``order_base`` on.  Returns the counts."""
    total, committed = 0, 0
    t0 = time.perf_counter()
    for wave, prods in enumerate(waves):
        T = prods.shape[0]
        inserts = (order_base + wave * T * 4
                   + np.arange(T * 4).reshape(T, 4))
        # one vectorized snapshot read serves the whole wave of clients
        _, rids, _ = db.snapshot_read(products, prods)
        rids = np_u32(rids)
        sessions = []
        for i in range(T):
            s = db.session(isolation=isolation).begin()
            s.put(products, prods[i],                   # 3 stock updates
                  np.ones((3, 4), np.uint32), read_cids=rids[i])
            s.put(products, inserts[i],                 # 4 blind inserts
                  np.ones((4, 4), np.uint32))
            sessions.append(s)
        ok = db.commit(sessions)                        # one routed commit
        total += T
        committed += int(ok.sum())
    return {"sessions": total, "committed": committed,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--isolation", default="rsi", choices=("rsi", "2pc"),
                    help="commit backend behind the same Session API")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    db = Database(device=dev)
    products = db.create_table("products", N_PRODUCTS + 100_000,
                               payload_words=4)
    products.seed(np.arange(N_PRODUCTS))         # base rows at load epoch
    out = checkout_waves(db, products, draw_products(),
                         isolation=args.isolation)
    total, committed, dt = out["sessions"], out["committed"], out["seconds"]
    print(f"{total} checkout txns, {committed} committed "
          f"({100*committed/total:.1f}%), {total/dt:,.0f} txn/s local "
          f"(compute only; see bench/fig6 for the network model)")
    out["read_timestamp"] = db.read_timestamp()
    print(f"oracle read timestamp after run: {out['read_timestamp']}")
    out["consecutive_committed"] = int(
        rsi.highest_committed(products.store["bitvec"][2:18]))
    print(f"timestamp bitvector: consecutive committed after load = "
          f"{out['consecutive_committed']}")
    out["txn_stats"] = dict(db.txn_stats)
    print("per-commit message economics (fabric transport counters, "
          "every call counted):")
    out["fabric"] = {}
    for verb, s in sorted(db.fabric_stats().items()):
        per = s["msgs"] / total
        out["fabric"][verb] = {"msgs": s["msgs"], "bytes": s["bytes"]}
        print(f"  {verb:>9}: {s['msgs']:>6} msgs  {s['bytes']:>9} B  "
              f"({per:.2f} msgs/txn)")
    return out


if __name__ == "__main__":
    main()
