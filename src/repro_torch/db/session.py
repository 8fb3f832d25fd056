"""Sessions: the facade's transaction API.

The port of ``repro.db.session``.  A :class:`Session` is one client
connection: ``begin()`` takes a read snapshot from the database's
timestamp oracle, ``get`` runs counted snapshot reads against a table's
version store, ``put`` buffers writes, and the database commits every
session of a wave in ONE routed fabric commit.  ``"rsi"`` (default) is the
paper's protocol, ``"2pc"`` the coordinator baseline: same outcome,
different message economics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._bits import CID_MASK, np_u32
from repro_torch.core import rsi

ISOLATION_LEVELS = ("rsi", "2pc")


class Session:
    """One client transaction at a time; writes buffer until commit."""

    def __init__(self, db, isolation: str = "rsi"):
        if isolation not in ISOLATION_LEVELS:
            raise ValueError(f"isolation {isolation!r} not in "
                             f"{ISOLATION_LEVELS}")
        self.db = db
        self.isolation = isolation
        self.rid: Optional[int] = None      # read snapshot timestamp
        self.cid: Optional[int] = None      # assigned at commit (latest)
        self.committed: Optional[bool] = None
        self.txn_id: Optional[int] = None   # first claimed cid, stable
                                            # across retries
        self.attempts: int = 0              # fabric commit rounds run
        self._table: Optional[str] = None   # single-table txn (v1)
        self._recs: list = []
        self._payload: list = []
        self._read_cids: list = []

    # ----------------------------------------------------------- txn API --

    def begin(self, rid: Optional[int] = None) -> "Session":
        """Start a transaction; rid defaults to the oracle's current read
        timestamp."""
        self.rid = self.db.read_timestamp() if rid is None else int(rid)
        self.cid = None
        self.committed = None
        self.txn_id = None
        self.attempts = 0
        self._table, self._recs = None, []
        self._payload, self._read_cids = [], []
        return self

    def get(self, table, recs):
        """Snapshot-read records at this session's rid (counted READs).
        Returns (payload, read_cids, ok) tensors on the database's device;
        pass read_cids back into put() for validated updates."""
        self._check_open()
        t = self.db.table(table)
        recs = torch.as_tensor(np.asarray(recs, np.int32), device=t.device)
        return rsi.read_snapshot(t.store, recs, self.rid,
                                 transport=self.db.transport,
                                 region_ns=f"{t.schema.name}/")

    def put(self, table, recs, payload, read_cids=None):
        """Buffer writes: recs (W,), payload (W, m) u32 words (numpy, or
        int32 bit patterns as a tensor); read_cids (W,) is the CID each
        record was read under (None = blind insert at CID 0)."""
        self._check_open()
        t = self.db.table(table)
        name = t.schema.name
        if self._table is not None and self._table != name:
            raise NotImplementedError(
                f"multi-table transaction ({self._table} + {name}): one "
                "store per routed commit in v1")
        self._table = name
        recs = np.asarray(recs, np.int32).reshape(-1)
        payload = np_u32(payload).reshape(recs.shape[0],
                                          t.schema.payload_words)
        rcids = (np.zeros(recs.shape[0], np.uint32) if read_cids is None
                 else np_u32(read_cids).reshape(-1))
        self._recs.append(recs)
        self._payload.append(payload)
        self._read_cids.append(rcids)
        return self

    def commit(self, **kw) -> bool:
        """Commit this transaction alone (a one-session wave)."""
        return bool(self.db.commit([self], **kw)[0])

    def refresh_read_cids(self) -> "Session":
        """Retry path after an abort: re-read the current word of every
        buffered write record (ONE counted READ) and revalidate against
        it.  The payload stays as buffered."""
        if self._table is None:
            return self
        t = self.db.table(self._table)
        recs = np.concatenate(self._recs)
        words = self.db.transport.read(
            t.store["words"], torch.as_tensor(recs, device=t.device),
            region=f"{t.schema.name}/words")
        self._recs = [recs]
        self._payload = [np.concatenate(self._payload)]
        self._read_cids = [np_u32(words) & np.uint32(CID_MASK)]
        self.rid = self.db.read_timestamp()
        return self

    # ---------------------------------------------------------- internals --

    def _check_open(self):
        if self.rid is None:
            raise RuntimeError("call begin() first")

    @property
    def table_name(self) -> Optional[str]:
        return self._table

    def writes(self):
        """(recs (W,), payload (W, m), read_cids (W,)) — the buffered write
        set, concatenated (numpy)."""
        if not self._recs:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, 0), np.uint32),
                    np.zeros((0,), np.uint32))
        return (np.concatenate(self._recs),
                np.concatenate(self._payload),
                np.concatenate(self._read_cids))

    # -------------------------------------------------------- context mgr --

    def __enter__(self):
        return self.begin()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.committed is None and self._recs:
            self.commit()
        return False
