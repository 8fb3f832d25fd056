"""The paper's §4.3 TPC-W checkout, driven through the port's facade.

Each checkout session reads 3 products drawn uniformly from the seeded
base rows, writes their new stock rows under the read cids, and
blind-inserts 4 rows never used before (W = 7 writes).  A wave of
sessions commits as one ``Database.commit`` with bounded retry.  Inputs
come from numpy with a seed; every size is a parameter.

``chip_smoke.py`` runs it at the paper's width on the card, on one shard
and on n (:func:`database`), and ``repro_torch.bench.profile_commit``
profiles one wave of it.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from repro_torch._bits import np_u32
from repro_torch.configs import OLTP
from repro_torch.db import Database
from repro_torch.fabric import make_transport

PRODUCTS = OLTP.num_products                  # base rows of the §4.3 store
PAYLOAD_WORDS = OLTP.record_bytes // 4        # a 1 KB record in u32 words
W_READ, W_INSERT = OLTP.updates_per_txn, OLTP.inserts_per_txn


def plan(*, seed: int, waves: int, T: int, products: int,
         payload_words: int):
    """Per wave: products (T, 3) uniform over [0, products), insert rows
    (T, 4) past the products and never reused, payload (T, 7, m) u32."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(waves):
        prods = rng.integers(0, products, (T, W_READ)).astype(np.int32)
        ins = (products + (w * T + np.arange(T))[:, None] * W_INSERT
               + np.arange(W_INSERT)[None, :]).astype(np.int32)
        pay = rng.integers(0, 2 ** 32, (T, W_READ + W_INSERT, payload_words),
                           dtype=np.uint32)
        out.append((prods, ins, pay))
    return out


def database(shards: int = 1, *, device=None, impl=None) -> Database:
    """A Database on one shard or, over a ``MeshTransport``, on n: the
    store range-sharded by home shard, each wave's clients in n equal
    blocks (so waves commit with ``max_retries=0`` at n > 1)."""
    return Database(make_transport(shards, device=device, impl=impl))


def create_table(db, *, products: int, waves: int, T: int,
                 payload_words: int):
    """The ``products`` table: seeded base rows plus room for every
    wave's inserts, one version slot."""
    t = db.create_table("products", products + waves * T * W_INSERT,
                        payload_words=payload_words, version_slots=1)
    return t.seed(np.arange(products))


def sessions(db, wave):
    """One Session per checkout of a wave: begin, get 3 products, put 3
    updates under their read cids and 4 inserts."""
    prods, ins, pay = wave
    out = []
    for i in range(prods.shape[0]):
        s = db.session().begin()
        _, rcids, _ = s.get("products", prods[i])
        s.put("products", prods[i], pay[i, :W_READ], rcids)
        s.put("products", ins[i], pay[i, W_READ:])
        out.append(s)
    return out


def drive(db, waves, *, max_retries: int = 2, around=None):
    """Each wave's sessions, then one ``Database.commit`` of the wave.
    Returns (committed masks, all sessions, host seconds per commit).
    ``around()``, if given, makes a context manager entered around each
    commit (a profiler window)."""
    masks, every, commit_s = [], [], []
    for wave in waves:
        ss = sessions(db, wave)
        with (around() if around else contextlib.nullcontext()):
            t0 = time.perf_counter()
            masks.append(db.commit(ss, max_retries=max_retries))
            commit_s.append(time.perf_counter() - t0)
        every += ss
    return masks, every, commit_s


def check_readback(db, every, *, sample: int = 256) -> dict:
    """Every committed write reads back through ``snapshot_read``: each
    written row holds its last writer's version, and (for a sample of
    rows) that version is visible at the writer's own cid.  Raises on a
    mismatch."""
    last = {}
    for s in sorted((s for s in every if s.committed), key=lambda s: s.cid):
        recs, pay, _ = s.writes()
        for r, p in zip(recs, pay):
            last[int(r)] = (s.cid, p)
    recs = np.fromiter(last, np.int32)
    want_pay = np.stack([last[int(r)][1] for r in recs])
    want_cid = np.array([last[int(r)][0] for r in recs], np.uint32)
    pay, cid, ok = db.snapshot_read("products", recs)
    if not (bool(ok.all()) and np.array_equal(np_u32(pay), want_pay)
            and np.array_equal(np_u32(cid), want_cid)):
        raise AssertionError("a committed write did not read back")
    for r in recs[:sample]:
        c, p = last[int(r)]
        pay, _, ok = db.snapshot_read("products", [r], rid=c)
        if not (bool(ok[0]) and np.array_equal(np_u32(pay)[0], p)):
            raise AssertionError(f"row {r} did not read back at cid {c}")
    return {"rows": int(recs.size), "own_cid_checked": min(sample, recs.size)}
