"""Deterministic Zipf transaction workloads (the fig_scale key streams).

A numpy-only copy of the JAX package's ``benchmarks/workloads.py``: the
same seeds give the same key streams in both packages.

*The End of a Myth* runs its million-transaction curves under
Zipf-skewed key popularity because uniform OLTP hides what limits
scale-out: hot-row conflicts.  Two rules:

  * **All randomness is host-side, seeded, at setup time**
    (``np.random.default_rng(seed)``); nothing in a commit path consults
    an RNG, so a fig_scale run is bit-reproducible.
  * **Inverse-CDF sampling over explicit rank weights**: the empirical
    frequency of rank r tracks ``r^-s`` by construction.

Two access patterns, matching the two fig_scale panels:

  ``shared=True``  every worker draws from ONE global Zipf over the whole
                   table: rank 1 is the same record for everyone, so skew
                   turns into cross-worker write-write conflicts (the
                   abort-economics panel).
  ``shared=False`` TPC-C-style home affinity: worker ``w`` draws from a
                   Zipf over its own contiguous key range, so its hot
                   keys are its shard's keys (the locality panel).
"""
from __future__ import annotations

import numpy as np

__all__ = ["zipf_weights", "zipf_keys", "worker_write_sets"]


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n: P(rank r) ∝ r^-s (s=0 is
    uniform).  Rank 1 == key 0: the hottest key is the lowest id, so a
    range-partitioned table keeps each stream's hot head in one shard."""
    n = int(n)
    if n < 1:
        raise ValueError("need at least one key")
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** -float(s)
    return w / w.sum()


def zipf_keys(num: int, n: int, s: float, *, seed: int = 0,
              base: int = 0) -> np.ndarray:
    """``num`` keys in [base, base+n) by inverse-CDF over
    :func:`zipf_weights` — one vectorized ``rng.random`` draw at setup
    time, deterministic in ``seed``, no RNG anywhere near a commit path."""
    rng = np.random.default_rng(seed)
    u = rng.random(int(num))
    if s <= 0.0:
        keys = np.minimum((u * n).astype(np.int64), n - 1)
    else:
        cdf = np.cumsum(zipf_weights(n, s))
        cdf[-1] = 1.0                      # guard fp round-off at the tail
        keys = np.searchsorted(cdf, u, side="right").astype(np.int64)
    return keys + int(base)


def weighted_sample(rng, p: np.ndarray, cdf: np.ndarray, k: int) -> np.ndarray:
    """``rng.choice(len(p), size=k, replace=False, p=p)``, the same
    indices from the same generator state, with the first round's cdf
    given (``cdf = cumsum(p) / its last``) instead of rebuilt each call.
    numpy's algorithm: draw the k - found uniforms, zero the found
    weights, invert the cdf, keep the first of each distinct index, and
    repeat until k are found.  Only a round after two draws collide
    rebuilds the cdf, so a call is O(k log n), not O(n): what lets a
    million-record Zipf stream be drawn in seconds."""
    found = np.zeros((k,), np.int64)
    n_uniq = 0
    pz = None
    while n_uniq < k:
        x = rng.random((k - n_uniq,))
        if n_uniq > 0:
            if pz is None:
                pz = p.copy()
            pz[found[:n_uniq]] = 0
            c = np.cumsum(pz)
            c /= c[-1]
        else:
            c = cdf
        new = c.searchsorted(x, side="right")
        _, first = np.unique(new, return_index=True)
        first.sort()
        new = new.take(first)
        found[n_uniq:n_uniq + new.size] = new
        n_uniq += new.size
    return found


def worker_write_sets(num_workers: int, txns_per_worker: int,
                      writes_per_txn: int, num_records: int, *,
                      skew: float = 0.0, seed: int = 0,
                      shared: bool = True) -> list:
    """Per-worker transaction write sets: a list of ``num_workers`` int
    arrays of shape (txns_per_worker, writes_per_txn), records distinct
    *within* each transaction (a txn CASes each of its rows once).

    shared=True draws every worker from one global Zipf (cross-worker
    hot-row contention); shared=False gives worker ``w`` a Zipf over its
    own home range of ``num_records // num_workers`` keys (home-affine:
    the locality panel's workload).  Worker streams get decorrelated,
    deterministic per-worker seeds derived from ``seed``.  The skewed
    draws go through :func:`weighted_sample`: the JAX benchmark's
    ``rng.choice`` streams, with the Zipf weights and their cdf built
    once (every worker draws from ranges of one size)."""
    num_workers = int(num_workers)
    R = int(num_records)
    wpt = int(writes_per_txn)
    rpw = max(R // num_workers, wpt)
    n = R if shared else min(rpw, R)
    p = cdf = None
    if skew > 0.0:
        p = zipf_weights(n, skew)
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
    out = []
    for w in range(num_workers):
        base = 0 if shared else min(w * rpw, R - rpw)
        rng = np.random.default_rng([int(seed), w])
        sets = np.empty((int(txns_per_worker), wpt), np.int64)
        for t in range(int(txns_per_worker)):
            # distinct rows per txn, still Zipf-weighted across txns
            sets[t] = (rng.choice(n, size=wpt, replace=False) if p is None
                       else weighted_sample(rng, p, cdf, wpt))
        out.append(sets + base)
    return out
