"""Deterministic, resumable, work-stealing data pipeline (a port of
``repro.data.pipeline``).

Synthetic LM token stream: batch content is a counter hash of (seed,
step, row, column), so a resume from any step is exact and any loader
worker can produce any shard, which is what makes work-stealing safe.
The numpy arithmetic is the JAX package's, uint64 wrap included, so the
batches are equal to its batches bit for bit.  Batches are numpy arrays;
the trainer moves them to its device.  The shards of a step's batch are
work items of a :class:`~repro_torch.core.workqueue.WorkQueue` (the
paper's §3.2 decentralized load balancing).  :class:`Prefetcher` builds
batches ahead on a background thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.core.workqueue import WorkQueue, run_workers

#: seconds a put waits on a full queue before it looks at ``close`` again
PUT_TIMEOUT_S = 1.0


def _hash2d(step: int, rows, cols, seed: int, mod: int):
    """splitmix-ish counter hash -> int32 [0, mod)."""
    x = (np.uint64(step + 1) * np.uint64(0x9E3779B97F4A7C15)
         + rows[:, None].astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         + cols[None, :].astype(np.uint64) * np.uint64(0x94D049BB133111EB)
         + np.uint64(seed) * np.uint64(0xD6E8FEB86659FD93))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    return (x % np.uint64(mod)).astype(np.int32)


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_workers: int = 4
    modality: tuple = None     # (num_tokens, dim) stub frontend features
    step: int = 0              # resumable cursor

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st):
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def _shard(self, step: int, row0: int, rows: int):
        r = np.arange(row0, row0 + rows)
        c = np.arange(self.seq_len + 1)
        toks = _hash2d(step, r, c, self.seed, self.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.modality:
            m, d = self.modality
            out["modality"] = (_hash2d(step, r, np.arange(m * d),
                                       self.seed + 1, 1000)
                               .reshape(rows, m, d).astype(np.float32)
                               / 1000.0)
        return out

    def next_batch(self, *, slow_worker=None):
        """Producers build the batch shard by shard through the work queue
        (steal-balanced), then the shards are assembled in order."""
        step = self.step
        self.step += 1
        shards = max(min(self.num_workers * 2, self.global_batch), 1)
        while self.global_batch % shards:
            shards -= 1
        rows = self.global_batch // shards
        wq = WorkQueue(self.num_workers)
        for i in range(shards):
            wq.push(i % self.num_workers, i)
        results = {}
        lock = threading.Lock()

        def work(i):
            shard = self._shard(step, i * rows, rows)
            with lock:
                results[i] = shard

        run_workers(wq, work, slow_worker=slow_worker)
        parts = [results[i] for i in range(shards)]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}


class Prefetcher:
    """Background prefetch (depth-N): the storage manager's prefetching of
    §3.2 applied to the input pipeline.

    A thread calls ``it_fn()`` and puts each batch on a queue of ``depth``
    batches.  A put that meets a full queue waits ``PUT_TIMEOUT_S`` and is
    retried with the same batch, so the stream is ``it_fn``'s, in order,
    with none lost however slowly it is consumed (JAX's loop builds a new
    batch after a full queue, dropping the one it held).  :meth:`close`
    stops the thread at its next put or build."""

    def __init__(self, it_fn, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                batch = it_fn()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=PUT_TIMEOUT_S)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def next(self, timeout=30):
        return self._q.get(timeout=timeout)

    def close(self) -> bool:
        """Stop the thread and wait for it, at most two put timeouts;
        returns whether it has ended."""
        self._stop.set()
        self._t.join(2 * PUT_TIMEOUT_S)
        return not self._t.is_alive()
