"""Tables: relations bound to NamPool regions (the OLTP half).

The port of ``repro.db.table``.  A :class:`Table` is an RSI version store
(lock|CID words, version slots, payload, timestamp bitvector — paper
Table 1) allocated as named regions, with a declared home-shard
partitioning.  Its lock-word column doubles as a lock service:
:meth:`Table.claim_locks` / :meth:`Table.release_lock` run the RSI CAS
through the database's transport, counted like every other verb.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._bits import LOCK_BIT, np_to_i32
from repro_torch.core import rsi
from repro_torch.core.rsi import WORD
from repro_torch.db import partition


@dataclass(frozen=True)
class TableSchema:
    name: str
    num_records: int
    payload_words: int = 4         # value width in 32-bit words
    version_slots: int = 1
    partitioning: str = "range"    # OLTP home-shard rule: "range" | "hash"


class Table:
    """One relation: an RSI version store on the transport's device."""

    def __init__(self, schema: TableSchema, pool, transport, *,
                 num_timestamps: int = 60_000):
        if schema.partitioning not in ("range", "hash"):
            raise ValueError(f"unknown partitioning {schema.partitioning!r}")
        self.schema = schema
        self._transport = transport
        self.cfg = rsi.StoreCfg(
            num_records=schema.num_records,
            payload_words=schema.payload_words,
            version_slots=schema.version_slots,
            num_timestamps=num_timestamps)
        R = schema.num_records
        pool.alloc(f"{schema.name}/words", (R,), WORD, ("record",))
        pool.alloc(f"{schema.name}/payload",
                   (R, schema.version_slots, schema.payload_words), WORD,
                   ("record", None, None))
        pool.alloc(f"{schema.name}/cids", (R, schema.version_slots), WORD,
                   ("record", None))
        pool.alloc(f"{schema.name}/bitvec", (num_timestamps,), torch.bool,
                   ("record",))
        self.store = rsi.init_store(self.cfg, transport.device)
        self.rows = 0              # live rows

    @property
    def device(self) -> torch.device:
        return self._transport.device

    def seed(self, recs, vals=None, *, cid: int = 1):
        """Mark records ``recs`` as existing at ``cid`` (OLTP base rows);
        ``vals`` (len(recs), m) u32 fills their newest version."""
        recs_np = np.asarray(recs, np.int64).reshape(-1)
        idx = torch.from_numpy(recs_np).to(self.device)
        word = int(np_to_i32([cid])[0])
        self.store["words"][idx] = word
        self.store["cids"][idx, 0] = word
        if vals is not None:
            self.store["payload"][idx, 0] = torch.from_numpy(
                np_to_i32(vals)).to(self.device)
        self.rows = max(self.rows, int(np.max(recs_np)) + 1)
        return self

    def home_shard(self, recs, num_shards: int = None) -> np.ndarray:
        """Home shard of each record under the declared partitioning
        (default cluster size: the bound transport's)."""
        n = self._transport.n if num_shards is None else int(num_shards)
        return partition.home_shard(recs, self.schema.num_records, n,
                                    self.schema.partitioning)

    # -------------------------------------------------------- lock column --

    def claim_locks(self, n: int, *, tag: int = 0) -> list:
        """Claim up to ``n`` free rows of a DEDICATED lock table with the
        RSI validate+lock CAS (counted through the transport).  Returns the
        claimed rows.  Refused on a seeded table, whose zero words mean
        unborn records, not free locks."""
        if self.rows:
            raise ValueError(
                f"claim_locks on data table {self.schema.name!r}: the lock "
                "column doubles as lock|CID words there; use a dedicated "
                "(never seeded/loaded) lock table")
        words = self.store["words"]
        cand = torch.nonzero(words == 0)[:n, 0].to(torch.int32)
        k = cand.numel()
        if k == 0:
            return []
        expected = torch.zeros((k,), dtype=WORD, device=self.device)
        new = torch.full((k,), LOCK_BIT | (int(tag) & 0x7FFFFFFF),
                         dtype=WORD, device=self.device)
        ok, self.store["words"] = self._transport.cas(
            words, cand, expected, new, region=f"{self.schema.name}/words")
        return [int(i) for i in cand[ok].tolist()]

    def release_lock(self, row: int, *, signaled: bool = False):
        """Unlock a claimed row (one-sided WRITE of the lock word).
        ``signaled=True`` posts the WRITE async and waits its completion,
        which orders the release before a later re-claim."""
        idx = torch.tensor([row], dtype=torch.int32, device=self.device)
        zero = torch.zeros((1,), dtype=WORD, device=self.device)
        region = f"{self.schema.name}/words"
        if signaled:
            self.store["words"] = self._transport.write_async(
                self.store["words"], idx, zero, region=region).wait()
        else:
            self.store["words"] = self._transport.write(
                self.store["words"], idx, zero, region=region)

    def locked_rows(self) -> int:
        return int((self.store["words"] < 0).sum())
