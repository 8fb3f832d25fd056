"""Closed-loop waves of TPC-W checkouts through the facade.

``sessions_per_wave`` clients run one checkout at a time each.  A wave is
one session a client, built through ``Session`` (begin; get the products
it reads; put their updates, each product's stock word decremented from
what the session read; put its inserts), and the wave is committed by
one ``Database.commit``, which retries nothing; the next wave starts
when it returns.  A checkout reads ``reads_per_txn`` distinct products,
drawn uniformly or by a Zipf shared by all clients, and inserts
``inserts_per_txn`` rows (an order and its lines) into rows of the insert
region kept for it.  A checkout whose session aborts is run again by its
client in the next wave, as a new session that reads again, at most
``REEXECUTIONS`` times; then it has failed.  Each wave's new checkouts
and their payloads are drawn when the wave starts, from one generator
seeded once.  The sessions of ``repro_torch.bench.checkout``, with the
draw made here.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from nambench import draw
from nambench.reference.oltp import SnapshotStore

TABLE = "products"
REEXECUTIONS = 2              # runs of an aborted checkout after its first
WARMUP_WAVES = 2              # unmeasured waves before the window
READBACK_ROWS = 1 << 16       # rows a snapshot read of the check
OWN_CID_SAMPLE = 256          # rows read back at their writer's own cid
COMPARE_ROWS = 1 << 20        # store rows a comparison on the device


def setup(config: dict, traffic: dict, seed: int, device):
    from repro_torch.db import Database
    P = int(config["num_products"])
    m = int(config["payload_words"])
    inserts = int(config["inserts_per_txn"])
    region = int(config["insert_rows"])
    db = Database(device=device)
    db.create_table(TABLE, P + region, payload_words=m,
                    version_slots=int(config["version_slots"]))
    db.table(TABLE).seed(np.arange(P))
    st = SimpleNamespace(
        db=db, P=P, m=m, T=int(traffic["sessions_per_wave"]),
        reads=int(config["reads_per_txn"]), inserts=inserts,
        capacity=region // inserts,
        cdf=draw.zipf_cdf(P, float(traffic["zipf_s"])),
        rng=np.random.default_rng([int(seed), 3]),
        next_id=0, waves=[], seed=int(seed))
    st.carry = _draw_new(st, 0)
    for _ in range(WARMUP_WAVES):
        unit(st)
    return st


def _draw_new(st, count: int):
    """``count`` new checkouts: their ids, products, payloads (the
    updates' word 0 is replaced by the stock the session computes) and
    runs so far (1: the one about to start)."""
    if st.next_id + count > st.capacity:
        raise RuntimeError(f"the insert region holds {st.capacity} "
                           "checkouts and they are spent: raise insert_rows "
                           "in the configuration")
    ids = np.arange(st.next_id, st.next_id + count)
    st.next_id += count
    prods = draw.distinct_rows(count, st.reads, st.P, st.cdf, st.rng)
    pay = st.rng.integers(-2 ** 31, 2 ** 31, (count, st.reads + st.inserts,
                                              st.m), dtype=np.int32)
    return ids, prods.astype(np.int32), pay, np.ones(count, np.int64)


def inserts_of(st, ids: np.ndarray) -> np.ndarray:
    """(len(ids), inserts) rows kept for checkouts ``ids``, past the
    products."""
    return (st.P + ids[:, None] * st.inserts
            + np.arange(st.inserts)[None, :]).astype(np.int32)


def sessions(db, prods, ins, pay, reads: int) -> list:
    """One session a checkout: read its products at the wave's snapshot,
    write each back with its stock word one lower, insert its rows."""
    opened, stock = [], []
    for i in range(prods.shape[0]):
        s = db.session().begin()
        got, rcids, _ = s.get(TABLE, prods[i])
        opened.append((s, rcids))
        stock.append(got[:, 0])
    upd = pay[:, :reads].copy()
    upd[:, :, 0] = torch.stack(stock).cpu().numpy() - np.int32(1)
    for i, (s, rcids) in enumerate(opened):
        s.put(TABLE, prods[i], upd[i], rcids)
        s.put(TABLE, ins[i], pay[i, reads:])
    return [s for s, _ in opened]


def _wire_bytes(db) -> int:
    return sum(v.get("bytes", 0) for v in db.transport.stats().values())


def unit(st) -> dict:
    """One wave: the checkouts carried from the last wave first, then new
    ones up to ``sessions_per_wave``."""
    new = _draw_new(st, st.T - st.carry[0].size)
    ids, prods, pay, runs = (np.concatenate([a, b])
                             for a, b in zip(st.carry, new))
    ins = inserts_of(st, ids)
    wire = _wire_bytes(st.db)
    t0 = time.perf_counter()
    with record_function("nambench.sessions"):
        ss = sessions(st.db, prods, ins, pay, st.reads)
    t1 = time.perf_counter()
    with record_function("nambench.commit"):
        mask = st.db.commit(ss)
    t2 = time.perf_counter()
    st.waves.append((prods, ins, pay, mask,
                     np.array([s.cid for s in ss], np.uint32)))
    again = ~mask & (runs <= REEXECUTIONS)
    st.carry = (ids[again], prods[again], pay[again], runs[again] + 1)
    done = int(mask.sum())
    failed = int((~mask & ~again).sum())
    return {"attempted": done + failed, "failed": failed, "committed": done,
            "sessions": len(ss), "session_s": t1 - t0, "commit_s": t2 - t1,
            "latency_s": t2 - t0, "wire_bytes": _wire_bytes(st.db) - wire}


def _expected(flat_pay, src, stock, rows):
    """The payloads rows ``rows`` must hold: their last writer's drawn
    payload (the load's zeros where none wrote), a product's word 0 its
    stock by the reference."""
    s = src[rows]
    want = torch.where((s >= 0)[:, None], flat_pay[s.clamp(min=0)], 0)
    prod = rows < stock.shape[0]
    want[prod, 0] = stock[rows[prod]]
    return want


def check(st) -> list:
    """Replay every wave run (warm-up, window, traced slice) on the plain
    store; compare each session's outcome and timestamp, the store (words,
    versions' timestamps, payloads with every product's stock, bitvector),
    the facade's outcome counters, and read every acknowledged write back
    through the facade: at the newest snapshot, and (a seeded sample) at
    its own commit timestamp."""
    W = st.reads + st.inserts
    t = st.db.table(TABLE)
    ref = SnapshotStore(t.schema.num_records, st.P)
    reads = np.zeros((st.T, W), bool)
    reads[:, :st.reads] = True
    outcome_bad = 0
    for w, (prods, ins, _, mask, cids) in enumerate(st.waves):
        recs = np.concatenate([prods, ins], 1).astype(np.int64)
        pay_ids = w * st.T * W + np.arange(st.T * W).reshape(st.T, W)
        ok, cid = ref.commit_wave(recs, pay_ids, reads)
        outcome_bad += int(((ok != mask) | (cid != cids)).sum())
    counters = st.db.txn_stats
    stats_gap = sum(abs(counters[k] - ref.stats[k]) for k in ref.stats)

    dev = t.device
    flat_pay = torch.from_numpy(
        np.concatenate([p for _, _, p, _, _ in st.waves])).reshape(
            -1, st.m).to(dev)
    src = torch.from_numpy(ref.src).to(dev)
    stock = torch.from_numpy(ref.stock.view(np.int32)).to(dev)
    want_cid = torch.from_numpy(ref.cids.view(np.int32)).to(dev)
    store_bad = int((t.store["words"] != want_cid).sum())
    store_bad += int((t.store["cids"][:, 0] != want_cid).sum())
    store_bad += int((t.store["bitvec"].cpu().numpy()
                      != ref.bitvec(t.store["bitvec"].shape[0])).sum())
    for a in range(0, src.shape[0], COMPARE_ROWS):
        rows = torch.arange(a, min(a + COMPARE_ROWS, src.shape[0]),
                            device=dev)
        got = t.store["payload"][a:a + COMPARE_ROWS, 0, :]
        store_bad += int((got != _expected(flat_pay, src, stock, rows)
                          ).any(1).sum())

    rows = np.flatnonzero(ref.src >= 0)
    readback_bad = 0
    for a in range(0, rows.size, READBACK_ROWS):
        r = rows[a:a + READBACK_ROWS]
        pay, cid, ok = st.db.snapshot_read(TABLE, r)
        ri = torch.from_numpy(r).to(dev)
        bad = ((pay != _expected(flat_pay, src, stock, ri)).any(1)
               | (cid != want_cid[ri]) | ~ok)
        readback_bad += int(bad.sum())
    rng = np.random.default_rng([st.seed, 2])
    for r in rng.choice(rows, min(OWN_CID_SAMPLE, rows.size),
                        replace=False):
        pay, _, ok = st.db.snapshot_read(TABLE, [r], rid=int(ref.cids[r]))
        want = _expected(flat_pay, src, stock,
                         torch.tensor([int(r)], device=dev))
        if not (bool(ok[0]) and torch.equal(pay[0], want[0])):
            readback_bad += 1
    return [("outcome_mismatches", outcome_bad, 0),
            ("store_mismatches", store_bad, 0),
            ("readback_failures", readback_bad, 0),
            ("txn_stats_gap", stats_gap, 0)]
