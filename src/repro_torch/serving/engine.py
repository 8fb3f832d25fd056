"""Serving engine, dense mode (a port of ``repro.serving.engine``).

Decode slots form a pool registered as a ``repro_torch.db`` table: slot
allocation is the table's lock column, claimed with the same RSI
validate-and-lock CAS the facade uses for transactions (the port's
``cas_lock`` kernel on the card), and counted by the database's transport.

Every admitted request owns a dense decode slot for its whole lifetime;
prompts go through the decode path one token at a time, as in the JAX
engine.  Like it, the engine keeps one decode position for all slots,
which advances with every step: a wave's shorter prompts are padded with
token 0, and a slot's next occupant attends to the cache entries its
earlier occupants left.  The paged mode (KV blocks in a two-tier NAM
region) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.db import Database
from repro_torch.models import api


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int = 16
    out: list = field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_seq: int = 256,
                 paged: bool = False, device=None, impl=None):
        """device: where the slot table lives (the card unless the caller
        asks for the CPU; the parameters must be there too).  impl: the
        slot table's kernel dispatch (None: the CAS kernel on the card).
        Each engine has a database of its own (the JAX engine may share
        one; nothing in the port does yet)."""
        if paged:
            raise NotImplementedError(
                "not ported yet: paged serving (fabric/tier.py TieredStore, "
                "serving/paging.py) comes with ROADMAP queue 1 item 7")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.db = Database(device=self.device, impl=impl)
        self.slot_table = self.db.create_table(
            "decode_slots", num_records=slots, payload_words=1)
        self.state = api.init_decode_state(cfg, params, slots, max_seq)
        self.active: dict[int, Request] = {}

    @property
    def slot_words(self):
        """The slot table's lock column (0 = free, lock bit = claimed)."""
        return self.slot_table.store["words"]

    def _claim_slots(self, n: int):
        """Claim up to n free slots via the table's lock-column CAS."""
        return self.slot_table.claim_locks(n)

    def _release(self, slot: int):
        self.slot_table.release_lock(slot)

    def submit(self, reqs: list[Request]):
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
        done = []
        while self.active:
            done.extend(self.decode_round())
        return done
