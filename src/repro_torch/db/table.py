"""Tables: key/value relations bound to NamPool regions.

The port of ``repro.db.table``.  A :class:`Table` is an RSI version store
(lock|CID words, version slots, payload, timestamp bitvector — paper
Table 1) plus a join-key column, allocated as named regions, with a
declared home-shard partitioning.  OLAP relations are bulk-loaded with
:meth:`Table.load` (or :meth:`Database.load_table`), which also takes
columns held as numpy arrays, such as a JAX table's ``scan_arrays()``,
and read by the operators through :meth:`Table.scan_arrays`.  Its
lock-word column doubles as a lock service:
:meth:`Table.claim_locks` / :meth:`Table.release_lock` run the RSI CAS
through the database's transport, counted like every other verb.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._bits import LOCK_BIT, np_to_i32, to_i32
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
    key_bytes: int = 4             # join key width on the wire
    value_bytes: int = 4           # shuffled value width on the wire

    @property
    def tuple_bytes(self) -> int:
        """Wire width of one (key, value) tuple in an OLAP shuffle."""
        return self.key_bytes + self.value_bytes


def as_words(x, device) -> torch.Tensor:
    """A u32 column as a contiguous 1-D int32 bit-pattern tensor on
    ``device``: an int32 tensor as it is, any other tensor through its u32
    value, an array (a JAX table's ``scan_arrays()``, say) only if it is
    1-D and of integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype != WORD:
            x = to_i32(x.to(torch.int64))
        return x.reshape(-1).contiguous().to(device)
    a = np.asarray(x)
    if a.ndim != 1 or a.dtype.kind not in "iu":
        raise TypeError(f"a column must be a 1-D integer array, got "
                        f"{a.dtype} {a.shape}")
    return torch.from_numpy(np_to_i32(a)).to(device)


class Table:
    """One relation: an RSI version store + key column on the transport's
    device."""

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
        pool.alloc(f"{schema.name}/keys", (R,), WORD, ("record",))
        self.store = rsi.init_store(self.cfg, transport.device)
        # default join key = record id (OLTP tables); bulk loads replace it
        self.keys = torch.arange(R, dtype=WORD, device=transport.device)
        self.rows = 0              # live rows, feeds the planner's stats

    @property
    def device(self) -> torch.device:
        return self._transport.device

    def load(self, keys, vals, *, cid: int = 1):
        """Bulk-load an OLAP relation: row i holds (keys[i], vals[i]) as a
        committed version at ``cid`` (the load epoch); vals fill payload
        word 0.  Columns are u32: int32 bit-pattern tensors, or anything
        :func:`as_words` takes."""
        keys = as_words(keys, self.device)
        vals = as_words(vals, self.device)
        n = keys.shape[0]
        R = self.schema.num_records
        if n > R:
            raise ValueError(f"{n} rows > {R} records")
        if vals.shape[0] != n:
            raise ValueError(f"{vals.shape[0]} values for {n} keys")
        word = int(np_to_i32([cid])[0])
        self.keys.zero_()
        self.keys[:n] = keys
        for leaf in ("payload", "cids", "words"):
            self.store[leaf].zero_()
        self.store["payload"][:n, 0, 0] = vals
        self.store["cids"][:n, 0] = word
        self.store["words"][:n] = word
        self.rows = n
        return self

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

    # ------------------------------------------------------------- stats --

    def stats(self) -> dict:
        """Planner inputs: live rows and their wire bytes in a shuffle."""
        rows = self.rows or self.schema.num_records
        return {"rows": rows, "bytes": rows * self.schema.tuple_bytes}

    def scan_arrays(self):
        """The (keys, vals) u32 columns an OLAP operator eats: vals =
        payload word 0 of the newest version, live rows only."""
        rows = self.rows or self.schema.num_records
        return self.keys[:rows], self.store["payload"][:rows, 0, 0]

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

