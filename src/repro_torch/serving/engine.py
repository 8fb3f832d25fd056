"""Serving engine: continuous batching over a NAM-resident KV pool (a port
of ``repro.serving.engine``).

Decode slots form a pool registered as a ``repro_torch.db`` table: slot
allocation is the table's lock column, claimed with the same RSI
validate-and-lock CAS the facade uses for transactions (the port's
``cas_lock`` kernel on the card), and counted by the database's transport.
Like the JAX engine, the engine keeps one decode position for all slots,
which advances with every step.

Two modes:

  * **dense** (default): every admitted request owns a dense decode slot
    for its whole lifetime.  Prompts go through the decode path one token
    at a time, a wave's shorter prompts padded with token 0, and a slot's
    next occupant attends to the cache entries its earlier occupants left.
  * **paged** (``paged=True``): admitted requests may outnumber dense
    slots.  KV-cache blocks live in a two-tier NAM region
    (:class:`repro_torch.fabric.tier.TieredStore`).  Each round
    (:meth:`ServeEngine.tick`) a deterministic round-robin wave of at most
    ``slots`` requests is swapped into the dense state (cold blocks paged
    in over one-sided READs), decodes one token (a prompt token while
    ``Request.fed`` is short of the prompt), and is swapped out
    append-only (new blocks stored dirty, written back on eviction).
    With ``prefetch=True`` the next wave's blocks are requested with ONE
    ``read_async`` before this wave's decode.  Wave rotation, eviction
    and block allocation are deterministic, and the decoded tokens are
    the same for any hot-tier size >= 1 block.  Slot releases on swap-out
    and finish are signaled WRITEs: their completion fence orders each
    release before the CAS that re-claims the slot.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.db import Database
from repro_torch.fabric.tier import TieredStore
from repro_torch.models import api
from repro_torch.serving.paging import BlockAllocator, PagedKV, PageTable


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int = 16
    out: list = field(default_factory=list)
    slot: int = -1
    done: bool = False
    fed: int = 0                  # prompt tokens consumed (paged prefill)


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_seq: int = 256,
                 db: Optional[Database] = None, paged: bool = False,
                 block_tokens: int = 16,
                 max_resident: Optional[int] = None,
                 capacity_blocks: Optional[int] = None,
                 hot_blocks: Optional[int] = None,
                 hot_frac: Optional[float] = None, prefetch: bool = True,
                 decode_compute_s: float = 0.0, device=None, impl=None):
        """device: where the engine runs (the card unless the caller asks
        for the CPU, or the device of ``db`` when one is given; the
        parameters must be there too).  db: a shared ``Database`` (each
        engine gets a slot table of its own); by default a new one with
        ``impl``, the slot table's kernel dispatch (None: the CAS kernel
        on the card).  The paged-mode options are the JAX engine's:
        ``block_tokens`` a block, ``max_resident`` requests in the block
        space (default ``slots``), ``capacity_blocks`` cold blocks
        (default enough for ``max_resident`` requests), ``hot_blocks`` or
        ``hot_frac`` of them hot (default all), ``prefetch`` the next
        wave, and ``decode_compute_s``, the modeled decode time a round
        that an attached tracer records."""
        self.device = (db.device if db is not None and device is None
                       else resolve_device(device))
        if db is not None and db.device != self.device:
            raise ValueError(f"database on {db.device}, engine on "
                             f"{self.device}")
        if params["embed"].device != self.device:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.db = db if db is not None else Database(device=self.device,
                                                     impl=impl)
        name, k = "decode_slots", 2
        while name in self.db.tables:
            name, k = f"decode_slots_{k}", k + 1
        self.slot_table = self.db.create_table(
            name, num_records=slots, payload_words=1)
        self.state = api.init_decode_state(cfg, params, slots, max_seq)
        self.active: dict[int, Request] = {}

        self.paged = paged
        if not paged:
            return
        # ------------------------------------------------- paged mode ---
        self.kv = PagedKV(self.state, slots=slots, max_seq=max_seq,
                          block_tokens=block_tokens)
        if self.kv.block_words == 0:
            raise ValueError("paged mode needs at least one seq-axis leaf")
        self.block_tokens = block_tokens
        # aux (sequence-free) state pads into whole blocks, so the cold
        # region stays one fixed-width block space
        self._aux_blocks = (-(-self.kv.aux_words // self.kv.block_words)
                            if self.kv.aux_words else 0)
        self.max_resident = int(max_resident or slots)
        per_req = self.kv.blocks_per_slot + self._aux_blocks
        self.capacity_blocks = int(capacity_blocks
                                   or self.max_resident * per_req)
        if hot_blocks is None:
            hot_blocks = (self.capacity_blocks if hot_frac is None
                          else max(1, int(np.ceil(self.capacity_blocks
                                                  * hot_frac))))
        self.store = TieredStore(self.db.pool, self.db.transport,
                                 f"{name}_kv", self.capacity_blocks,
                                 self.kv.block_words,
                                 hot_blocks=int(hot_blocks))
        self.allocator = BlockAllocator(self.capacity_blocks)
        self.prefetch = prefetch
        self.decode_compute_s = float(decode_compute_s)
        self.waiting: list[Request] = []
        self.resident: dict[int, Request] = {}     # rid -> Request
        self.pages: dict[int, PageTable] = {}
        self._dense: list[Optional[int]] = [None] * slots  # slot -> rid
        self._pos_in = [0] * slots    # decode clock at swap-in, per slot
        self._cursor = 0              # round-robin wave rotation
        self._clock = 0               # the shared decode position

    @property
    def slot_words(self):
        """The slot table's lock column (0 = free, lock bit = claimed)."""
        return self.slot_table.store["words"]

    # ------------------------------------------------------ slot alloc --

    def _claim_slots(self, n: int):
        """Claim up to n free slots via the table's lock-column CAS."""
        return self.slot_table.claim_locks(n)

    def _release(self, slot: int, *, signaled: bool = False):
        self.slot_table.release_lock(slot, signaled=signaled)

    # ----------------------------------------------------- dense mode ---

    def submit(self, reqs: list[Request]):
        if self.paged:
            for r in reqs:
                self.enqueue(r)
            return
        free = self._claim_slots(len(reqs))
        if len(free) < len(reqs):
            raise RuntimeError(f"pool exhausted: {len(reqs)} requests, "
                               f"{len(free)} free slots")
        for r, s in zip(reqs, free):
            r.slot = s
            self.active[s] = r
        # prefill: feed prompts token by token through the decode path
        maxp = max(len(r.prompt) for r in reqs)
        for t in range(maxp):
            tok = np.zeros((self.slots, 1), np.int32)
            for r in reqs:
                if t < len(r.prompt):
                    tok[r.slot, 0] = r.prompt[t]
            self._step(tok)

    @torch.inference_mode()
    def _step(self, tok: np.ndarray) -> np.ndarray:
        tokens = torch.from_numpy(tok).to(self.device, torch.int64)
        logits, self.state = api.decode_step(self.cfg, self.params,
                                             self.state, tokens)
        return logits[:, 0].argmax(dim=-1).cpu().numpy()

    def decode_round(self):
        """One token for every active request (continuous batching)."""
        if self.paged:
            return self.tick()
        tok = np.zeros((self.slots, 1), np.int32)
        for s, r in self.active.items():
            tok[s, 0] = (r.out[-1] if r.out else
                         (r.prompt[-1] if len(r.prompt) else 0))
        nxt = self._step(tok)
        finished = []
        for s, r in list(self.active.items()):
            r.out.append(int(nxt[s]))
            if len(r.out) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
                del self.active[s]
                self._release(s)
        return finished

    def run(self, reqs: list[Request]):
        self.submit(reqs)
        if self.paged:
            return self.drain()
        done = []
        while self.active:
            done.extend(self.decode_round())
        return done

    # ----------------------------------------------------- paged mode ---

    def enqueue(self, req: Request):
        """Queue a request; it is admitted into the resident set (KV pages
        in the NAM block space) as capacity frees up."""
        if not self.paged:
            raise RuntimeError("enqueue() is the paged-mode entry point")
        self.waiting.append(req)

    def _admit(self):
        while self.waiting and len(self.resident) < self.max_resident:
            r = self.waiting.pop(0)
            self.resident[r.rid] = r
            self.pages[r.rid] = PageTable()

    def _wave_at(self, order: list, start: int) -> list:
        n = min(self.slots, len(order))
        return [order[(start + i) % len(order)] for i in range(n)]

    def _pick_wave(self) -> list:
        """Round-robin over resident rids: every request decodes within
        ceil(resident / slots) rounds of its last turn, whatever the
        residency, so neither the schedule nor the bits depend on the
        hot-tier size."""
        order = sorted(self.resident)
        if not order:
            return []
        start = self._cursor % len(order)
        wave = self._wave_at(order, start)
        self._cursor = start + len(wave)
        return wave

    def _will_finish(self, r: Request) -> bool:
        """Whether one more decode turn completes ``r``: a count, not a
        token value, so the next wave is exactly predictable."""
        return (r.fed >= len(r.prompt)
                and len(r.out) + 1 >= r.max_new_tokens)

    def _predict_next_wave(self, wave: list) -> list:
        fin = {rid for rid in wave if self._will_finish(self.resident[rid])}
        order = [rid for rid in self.resident if rid not in fin]
        room = self.max_resident - len(order)
        order += [r.rid for r in self.waiting[:max(room, 0)]]
        order.sort()
        if not order:
            return []
        return self._wave_at(order, self._cursor % len(order))

    def _swap_out(self, slot: int):
        """Evict ``slot``'s request from the dense state, append-only: only
        the blocks covering rows written since swap-in ([pos_in, clock))
        are stored (dirty), plus the aux page."""
        rid = self._dense[slot]
        pt = self.pages[rid]
        pos_in, pos_now = self._pos_in[slot], self._clock
        if pos_now <= pos_in:
            raise RuntimeError(f"dense slot {slot} never decoded")
        j0, j1 = pos_in // self.block_tokens, (pos_now - 1) // self.block_tokens
        js = list(range(j0, j1 + 1))
        rows = self.kv.extract_blocks(self.state, slot, js)
        ids = []
        for j in js:
            if j not in pt.blocks:
                pt.blocks[j] = self.allocator.alloc(1)[0]
            ids.append(pt.blocks[j])
        if self._aux_blocks:
            aux = self.kv.extract_aux(self.state, slot)
            pad = self._aux_blocks * self.kv.block_words - aux.shape[0]
            aux = torch.cat([aux, aux.new_zeros(pad)]).reshape(
                self._aux_blocks, self.kv.block_words)
            if not pt.aux:
                pt.aux = self.allocator.alloc(self._aux_blocks)
            ids.extend(pt.aux)
            rows = torch.cat([rows, aux])
        self.store.put(ids, rows, dirty=True)
        self._dense[slot] = None
        # signaled: orders this release before the CAS that re-claims the
        # slot for the next swap-in (else the lost update the race
        # detector flags)
        self._release(slot, signaled=True)

    def _swap_in(self, slot: int, rid: int):
        """Page ``rid``'s blocks into dense ``slot``: zero the slot, then
        land the stored blocks and the aux page through the tiered store
        (hot hits are free, cold misses ONE batched READ, in-flight
        prefetches waited here)."""
        pt = self.pages[rid]
        self.kv.zero_slot(self.state, slot)
        ids = pt.all_ids()
        if ids:
            rows = self.store.get(ids)
            js = sorted(pt.blocks)
            if js:
                self.kv.insert_blocks(self.state, slot, js, rows[:len(js)])
            if pt.aux:
                aux = rows[len(js):].reshape(-1)[:self.kv.aux_words]
                self.kv.insert_aux(self.state, slot, aux)
        self._dense[slot] = rid
        self._pos_in[slot] = self._clock
        self.resident[rid].slot = slot

    def _finish(self, rid: int):
        pt = self.pages.pop(rid)
        r = self.resident.pop(rid)
        slot = r.slot
        ids = pt.all_ids()
        if ids:
            self.store.drop(ids)
            self.allocator.release(ids)
        self._dense[slot] = None
        r.slot = -1
        self._release(slot, signaled=True)

    def tick(self):
        """One continuous-batching round: admit, rotate a wave into the
        dense slots, prefetch the next wave's cold blocks, then decode one
        token for the wave.  Returns the requests finished this round."""
        if not self.paged:
            raise RuntimeError("tick() is the paged-mode decode round")
        self._admit()
        wave = self._pick_wave()
        if not wave:
            return []
        wave_set = set(wave)
        for slot in range(self.slots):
            rid = self._dense[slot]
            if rid is not None and rid not in wave_set:
                self._swap_out(slot)
        dense_now = {rid for rid in self._dense if rid is not None}
        incoming = [rid for rid in wave if rid not in dense_now]
        if incoming:
            claimed = self._claim_slots(len(incoming))
            if len(claimed) < len(incoming):
                raise RuntimeError(f"slot pool exhausted: {len(incoming)} "
                                   f"incoming, {len(claimed)} claimed")
            for slot, rid in zip(claimed, incoming):
                self._swap_in(slot, rid)
        if self.prefetch:
            dense_now = {rid for rid in self._dense if rid is not None}
            ids = []
            for rid in self._predict_next_wave(wave):
                if rid not in dense_now and rid in self.pages:
                    ids.extend(self.pages[rid].all_ids())
            if ids:
                self.store.prefetch(ids)
        tracer = getattr(self.db.transport, "tracer", None)
        if tracer is not None and self.decode_compute_s > 0:
            tracer.emit_compute(self.decode_compute_s)
        tok = np.zeros((self.slots, 1), np.int32)
        for rid in wave:
            r = self.resident[rid]
            if r.fed < len(r.prompt):
                tok[r.slot, 0] = r.prompt[r.fed]
            else:
                tok[r.slot, 0] = (r.out[-1] if r.out else
                                  (r.prompt[-1] if len(r.prompt) else 0))
        nxt = self._step(tok)
        self._clock += 1
        if self._clock >= self.max_seq:
            raise RuntimeError("decode clock ran off max_seq")
        finished = []
        for rid in wave:
            r = self.resident[rid]
            if r.fed < len(r.prompt):
                r.fed += 1         # prefill turn: output discarded
            else:
                r.out.append(int(nxt[r.slot]))
            self.pages[rid].extent = self._clock
            if r.fed >= len(r.prompt) and len(r.out) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
                self._finish(rid)
        return finished

    def drain(self):
        """Tick until every queued and resident request has finished."""
        done = []
        while self.resident or self.waiting:
            done.extend(self.tick())
        return done

    def quiesce(self):
        """Wait outstanding prefetches (no dangling unsignaled READs)."""
        if self.paged:
            self.store.quiesce()
