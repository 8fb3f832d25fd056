"""The plain snapshot-isolation store: waves of checkouts committed one
after another, in NumPy.

The semantics the configuration states (NAM-DB's RSI, paper §4.2, one
version slot): a wave's sessions read their products at one snapshot,
the store as the previous wave left it; each session claims the next
commit timestamp in wave order; a write validates iff its record still
holds the version it was read under (an insert: no version), and among
a wave's valid writes to one record the first in (session, write) order
takes the lock; a session commits iff every one of its writes took its
lock, and then installs its versions.  A committed checkout decrements
the stock of each product it read (word 0 of the product's payload, from
the load's 0, mod 2^32).  A session that aborts leaves no version; its
checkout, executed again in a later wave, is a new session there.  The
clock starts at 2 (1 is the load epoch).
"""
from __future__ import annotations

import numpy as np


class SnapshotStore:
    """Per record: its newest version's commit timestamp (``cids``), the
    id of the payload it holds (``src``, -1 for the load's) and its stock
    word (``stock``, products only)."""

    def __init__(self, records: int, base_rows: int, clock: int = 2):
        self.cids = np.zeros(records, np.uint32)
        self.cids[:base_rows] = 1
        self.src = np.full(records, -1, np.int64)
        self.stock = np.zeros(base_rows, np.uint32)
        self.clock = clock
        self.stats = {"commits": 0, "aborts": 0}

    def commit_wave(self, recs, pay_ids, reads):
        """One wave: ``recs`` (T, W) records written, ``pay_ids`` (T, W)
        their payloads' ids, ``reads`` (T, W) True where the write updates
        a product the session read (False: a blind insert).  Returns each
        session's outcome and its commit timestamp."""
        k, w = recs.shape
        expect = np.where(reads, self.cids[recs], 0).astype(np.uint32)
        cid = (self.clock + np.arange(k)).astype(np.uint32)
        self.clock += k
        flat = recs.reshape(-1)
        valid = np.flatnonzero(self.cids[flat] == expect.reshape(-1))
        _, first = np.unique(flat[valid], return_index=True)
        granted = np.zeros(flat.size, bool)
        granted[valid[first]] = True
        ok = granted.reshape(k, w).all(1)
        rows = recs[ok].reshape(-1)
        self.cids[rows] = np.repeat(cid[ok], w)
        self.src[rows] = pay_ids[ok].reshape(-1)
        # one winner a record: no product is bought twice in a wave
        self.stock[recs[ok][reads[ok]]] -= np.uint32(1)
        self.stats["commits"] += int(ok.sum())
        self.stats["aborts"] += int((~ok).sum())
        return ok, cid

    def bitvec(self, slots: int) -> np.ndarray:
        """The timestamp bitvector: every claimed timestamp's bit set."""
        out = np.zeros(slots, bool)
        out[2:min(self.clock, slots)] = True
        return out
