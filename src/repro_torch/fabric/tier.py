"""Two-tier NAM block store: a bounded local hot tier in front of a
disaggregated cold region (the port of ``repro.fabric.tier``).

A :class:`TieredStore` manages one
:class:`~repro_torch.fabric.verbs.TieredRegion`: fixed-size u32 blocks
(int32 bit views, :mod:`repro_torch._bits`) whose authoritative copy lives
in a cold NAM region reached only by one-sided READ and WRITE, with at most
``hot_blocks`` of them cached in local memory.  The paged serving engine
pages KV-cache blocks through it (:mod:`repro_torch.serving.paging`); the
store itself is payload-agnostic.

Contracts, as in the JAX package:

  * **bit-exact at any hot size**: a block reads back the same bits
    whether it was a hot hit, a cold page-in, or evicted and re-read.  The
    hot tier changes traffic, never bits;
  * **deterministic eviction**: clock/LRU over a monotone epoch counter.
    Every hot touch stamps the block with the next epoch; the victim is
    the first free slot, else the lowest-epoch slot (lowest index on
    ties).  No RNG, no clock;
  * **signaled write-back**: a dirty victim goes back to the cold region
    through ``write_async(...).wait()``, whose completion fence orders it
    before any later page-in READ of the same block;
  * **batched prefetch**: :meth:`prefetch` issues ONE ``read_async`` for
    the missing blocks and parks its Completion; the first :meth:`get`
    that touches any of them waits it and lands the whole batch.

Residency bookkeeping is host numpy, as in JAX.  The hot and cold tiers
are tensors on the transport's device.  Unlike a JAX array, a row of
``hot`` is a view: a row handed out or queued for write-back is copied
out of the hot tier before a later install in the same call may
overwrite its slot.

Traffic: cold READ/WRITE go through the transport with ``tier="cold"``
(``read_cold``/``write_cold``: priced by a bound profile, traced for the
contention simulator); hot hits and hot writes are counted by
``Transport.count_local`` (``read_hot``/``write_hot``: local memory, never
wire).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch


class _PrefetchBatch:
    """One in-flight batched prefetch: the Completion of a single
    ``read_async`` covering ``blocks`` (in order)."""

    __slots__ = ("comp", "blocks")

    def __init__(self, comp, blocks: List[int]):
        self.comp = comp
        self.blocks = blocks


class TieredStore:
    """Residency manager for one two-tier block region.

    pool/transport: the NAM pool the cold region is allocated in and the
    transport its one-sided verbs travel on (a ``db.Database`` has both);
    the tiers live on the transport's device.  ``name`` must be
    pool-unique; ``hot_blocks`` is clamped to [1, n_blocks] (1: all-cold
    staging, n_blocks: the all-local baseline).
    """

    def __init__(self, pool, transport, name: str, n_blocks: int,
                 block_words: int, *, hot_blocks: int):
        self.tier = pool.alloc_tiered(name, n_blocks, block_words,
                                      hot_blocks=hot_blocks)
        self.transport = transport
        self.name = name
        self.n_blocks = self.tier.n_blocks
        self.block_words = self.tier.block_words
        self.hot_blocks = self.tier.hot_blocks
        self.device = transport.device
        self.cold = torch.zeros((self.n_blocks, self.block_words),
                                dtype=torch.int32, device=self.device)
        self.hot = torch.zeros((self.hot_blocks, self.block_words),
                               dtype=torch.int32, device=self.device)
        # host-side residency bookkeeping: the epoch counter is the only
        # notion of time
        self._slot_block = np.full((self.hot_blocks,), -1, np.int64)
        self._slot_epoch = np.zeros((self.hot_blocks,), np.int64)
        self._slot_dirty = np.zeros((self.hot_blocks,), bool)
        self._block_slot: Dict[int, int] = {}
        self._pending: Dict[int, _PrefetchBatch] = {}
        self._epoch = 0
        self._wb_blocks: List[int] = []
        self._wb_rows: List[torch.Tensor] = []
        self.counters = {"hits": 0, "misses": 0, "evictions": 0,
                         "writebacks": 0, "prefetched": 0, "drops": 0}

    def _index(self, blocks: List[int]) -> torch.Tensor:
        return torch.tensor(blocks, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------ residency ---

    def resident(self, block: int) -> bool:
        return int(block) in self._block_slot

    def resident_blocks(self) -> List[int]:
        """Hot-resident block ids, in hot-slot order."""
        return [int(b) for b in self._slot_block if b >= 0]

    def _touch(self, slot: int):
        self._epoch += 1
        self._slot_epoch[slot] = self._epoch

    def _victim(self) -> int:
        """First free slot, else the lowest-epoch slot (lowest index on
        ties)."""
        free = np.nonzero(self._slot_block < 0)[0]
        if free.size:
            return int(free[0])
        return int(np.argmin(self._slot_epoch))

    def _install(self, block: int, row, *, dirty: bool):
        """Place ``row`` in the hot tier under ``block``, evicting the
        victim; a dirty victim's row is copied out and queued for one
        signaled write-back at the end of the public op."""
        slot = self._victim()
        old = int(self._slot_block[slot])
        if old >= 0:
            self.counters["evictions"] += 1
            if self._slot_dirty[slot]:
                self._wb_blocks.append(old)
                self._wb_rows.append(self.hot[slot].clone())
            del self._block_slot[old]
        self.hot[slot] = row
        self._slot_block[slot] = int(block)
        self._slot_dirty[slot] = dirty
        self._block_slot[int(block)] = slot
        self._touch(slot)

    def _flush_writebacks(self):
        if not self._wb_blocks:
            return
        # signaled: wait() fires the WRITE-completion fence that orders
        # the write-back before any later page-in READ of the same block
        self.cold = self.transport.write_async(
            self.cold, self._index(self._wb_blocks),
            torch.stack(self._wb_rows), region=self.name,
            tier="cold").wait()
        self.counters["writebacks"] += len(self._wb_blocks)
        self._wb_blocks, self._wb_rows = [], []

    def _land(self, batch: _PrefetchBatch) -> Dict[int, torch.Tensor]:
        """Wait a prefetch batch (firing its READ-completion fence) and
        land every block of it in the hot tier, clean.  Returns the read
        rows (rows of the verb's own result, never of ``hot``)."""
        vals = batch.comp.wait()
        landed: Dict[int, torch.Tensor] = {}
        for i, b in enumerate(batch.blocks):
            self._pending.pop(b, None)
            landed[b] = vals[i]
            self._install(b, vals[i], dirty=False)
        return landed

    # ------------------------------------------------------------ ops ---

    def get(self, blocks: Sequence[int]) -> torch.Tensor:
        """Fetch blocks (any mix of hot hits, in-flight prefetches and cold
        misses) -> ``(len(blocks), block_words)`` int32.  Misses are ONE
        batched READ of the cold region; in-flight prefetch batches are
        waited here."""
        blocks = [int(b) for b in blocks]
        out: Dict[int, torch.Tensor] = {}
        hit: Dict[int, int] = {}                 # block -> hot slot
        for b in blocks:
            slot = self._block_slot.get(b)
            if slot is not None and b not in hit:
                hit[b] = slot
                self._touch(slot)
        if hit:
            # one gather, taken before any install below can reuse a slot
            rows = self.hot[torch.tensor(list(hit.values()),
                                         device=self.device)]
            out.update(zip(hit, rows))
            hits = len(hit)
            self.counters["hits"] += hits
            self.transport.count_local("read_hot", hits,
                                       hits * self.block_words * 4)
        for b in blocks:
            if b not in out and b in self._pending:
                landed = self._land(self._pending[b])
                for lb, row in landed.items():
                    out.setdefault(lb, row)
        missing = sorted({b for b in blocks if b not in out})
        if missing:
            self.counters["misses"] += len(missing)
            vals = self.transport.read(self.cold, self._index(missing),
                                       region=self.name, tier="cold")
            for i, b in enumerate(missing):
                out[b] = vals[i]
                self._install(b, vals[i], dirty=False)
        self._flush_writebacks()
        if not blocks:
            return torch.zeros((0, self.block_words), dtype=torch.int32,
                               device=self.device)
        return torch.stack([out[b] for b in blocks])

    def put(self, blocks: Sequence[int], vals, *, dirty: bool = True):
        """Store block rows (``vals``: ``(k, block_words)`` int32) through
        the hot tier.  Dirty blocks reach the cold region only on eviction:
        the hot tier is a write-back cache."""
        blocks = [int(b) for b in blocks]
        for i, b in enumerate(blocks):
            if b in self._pending:
                self._land(self._pending[b])     # overwrite an in-flight
            slot = self._block_slot.get(b)       # prefetch coherently
            if slot is not None:
                self.hot[slot] = vals[i]
                self._slot_dirty[slot] = self._slot_dirty[slot] or dirty
                self._touch(slot)
            else:
                self._install(b, vals[i], dirty=dirty)
        if blocks:
            self.transport.count_local("write_hot", len(blocks),
                                       len(blocks) * self.block_words * 4)
        self._flush_writebacks()

    def prefetch(self, blocks: Iterable[int]) -> int:
        """Issue ONE async cold READ for the blocks neither hot nor in
        flight and return how many it covers (0: nothing to do).  The first
        :meth:`get` touching any of them waits it; :meth:`quiesce` drains
        the rest."""
        missing = sorted({int(b) for b in blocks
                          if int(b) not in self._block_slot
                          and int(b) not in self._pending})
        if not missing:
            return 0
        comp = self.transport.read_async(self.cold, self._index(missing),
                                         region=self.name, tier="cold")
        batch = _PrefetchBatch(comp, missing)
        for b in missing:
            self._pending[b] = batch
        self.counters["prefetched"] += len(missing)
        return len(missing)

    def drop(self, blocks: Iterable[int]):
        """Free blocks (their owner finished): discard hot residency with
        no write-back; in-flight prefetches covering them are waited
        first."""
        for b in sorted({int(b) for b in blocks}):
            if b in self._pending:
                self._land(self._pending[b])
            slot = self._block_slot.pop(b, None)
            if slot is not None:
                self._slot_block[slot] = -1
                self._slot_epoch[slot] = 0
                self._slot_dirty[slot] = False
                self.counters["drops"] += 1
        self._flush_writebacks()

    def quiesce(self):
        """Wait every outstanding prefetch batch and flush queued
        write-backs: no unsignaled one-sided request is left."""
        while self._pending:
            self._land(next(iter(self._pending.values())))
        self._flush_writebacks()

    # ---------------------------------------------------------- stats ---

    def hit_rate(self) -> Optional[float]:
        """Hot-tier hit rate over all reads so far (None before any)."""
        tot = self.counters["hits"] + self.counters["misses"]
        return self.counters["hits"] / tot if tot else None

    def stats(self) -> dict:
        """Residency and traffic counters."""
        return {**self.counters,
                "n_blocks": self.n_blocks,
                "hot_blocks": self.hot_blocks,
                "block_words": self.block_words,
                "hot_fraction": self.tier.hot_fraction,
                "resident": len(self._block_slot),
                "pending": len(self._pending),
                "hit_rate": self.hit_rate()}
