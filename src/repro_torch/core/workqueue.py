"""Decentralized work-queue load balancing (paper §3.2); a port of
``repro.core.workqueue``.

The paper proposes a central work queue accessed with one-sided verbs so
idle nodes pull small portions of work, with no coordinator in the path.
The device-side primitive is the fabric's FETCH_ADD: every worker bumps
the shared head counter to claim a ticket range
(:func:`claim_ticket_ranges`).  The head is a u32 word carried as an
int32 bit pattern (:mod:`repro_torch._bits`), and FETCH_ADD updates it in
place.  The rest of the module is a host-only copy of the JAX package's
twin: a deque per worker with steal-from-the-back (the READ+CAS steal
analogue), used by the data pipeline.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import fabric


def claim_ticket_ranges(head, amounts, priority=None, transport=None):
    """Claim work-item ranges off a shared queue head with one FETCH_ADD
    per worker (paper §3.2's decentralized pull).

    head: (1,) int32 counter word (the queue's u32 head pointer region),
      updated in place.
    amounts: (W,) int32 per-worker claim sizes (u32 bit patterns).
    priority: (W,) int32 arbitration order (lower first; default = worker
      order), the fabric CAS's rule.
    transport: a fabric transport to issue (and count) the verb through;
      None = the raw verb (uncounted).
    Returns (starts (W,) int32, head): worker w owns
    [starts[w], starts[w] + amounts[w]).
    """
    amounts = amounts.to(torch.int32)
    idx = torch.zeros(amounts.shape, dtype=torch.int32,
                      device=amounts.device)          # all hit word 0
    if transport is None:
        return fabric.fetch_add(head, idx, amounts, priority=priority)
    return transport.fetch_add(head, idx, amounts, priority=priority,
                               region="queue/head")


@dataclass
class StealStats:
    local_pops: int = 0
    steals: int = 0
    failed_steals: int = 0


class WorkQueue:
    """Per-worker deques; the owner pops from the front, thieves steal
    from the back (the one-sided READ+CAS analogue)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self._qs = [collections.deque() for _ in range(num_workers)]
        self._locks = [threading.Lock() for _ in range(num_workers)]
        self.stats = [StealStats() for _ in range(num_workers)]

    def push(self, worker: int, item: Any):
        with self._locks[worker]:
            self._qs[worker].append(item)

    def push_many(self, worker: int, items):
        with self._locks[worker]:
            self._qs[worker].extend(items)

    def pop(self, worker: int) -> Optional[Any]:
        with self._locks[worker]:
            if self._qs[worker]:
                self.stats[worker].local_pops += 1
                return self._qs[worker].popleft()
        # idle: steal half from the longest victim's tail
        victim = max(range(self.num_workers),
                     key=lambda w: len(self._qs[w]))
        if victim == worker:
            return None
        with self._locks[victim]:
            q = self._qs[victim]
            if not q:
                self.stats[worker].failed_steals += 1
                return None
            take = max(1, len(q) // 2)
            stolen = [q.pop() for _ in range(take)]
        self.stats[worker].steals += 1
        item, rest = stolen[0], stolen[1:]
        if rest:
            self.push_many(worker, rest)
        return item

    def pending(self) -> int:
        return sum(len(q) for q in self._qs)


def run_workers(queue: WorkQueue, fn, *, slow_worker: Optional[int] = None,
                slow_factor: float = 5.0):
    """Drain the queue with one thread per worker; optionally handicap one
    worker to simulate a straggler.  Returns per-worker completed items."""
    done = [[] for _ in range(queue.num_workers)]

    def loop(w):
        while True:
            item = queue.pop(w)
            if item is None:
                if queue.pending() == 0:
                    return
                time.sleep(0.0005)
                continue
            t0 = time.perf_counter()
            fn(item)
            if slow_worker == w:
                time.sleep((time.perf_counter() - t0) * (slow_factor - 1)
                           + 1e-4)
            done[w].append(item)

    threads = [threading.Thread(target=loop, args=(w,))
               for w in range(queue.num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return done
