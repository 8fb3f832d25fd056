"""Locality-aware worker→shard placement (the fig_scale `locality=` axis).

The paper's NAM redesign separates compute from storage, but §4.3 (and
*The End of a Myth*'s scalability study) is explicit that the fast curve
still wants *locality of reference*: a worker whose hot keys live on its
own shard turns most prepare/install verbs into loopback traffic that
never touches the wire.  This module is the declarative half of that
argument:

  * :func:`home_shard` — where a record lives, straight from the table's
    declared partitioning (the same rule the RSI commit router bins by),
  * :func:`assign_workers` — which shard each worker runs next to.  With
    ``locality=True`` worker ``w`` is co-located with shard ``w % S`` (its
    home-affine key range is loopback); ``locality=False`` is the
    adversarial derangement ``(w + 1) % S`` — every worker sits exactly
    one shard away from its hot range, so the *same* workload pays full
    wire price for every hot-key verb,
  * :func:`local_fraction` — the measured share of a write set that stays
    loopback under a placement, which is the number fig_scale reports
    next to the throughput delta.

Keeping the toggle a pure placement function (not a data migration) is
the point: the workload, the store contents, and the verb *counts* are
identical on both sides — only src→dst distances change, which is exactly
the quantity the netsim tracer prices.
"""
from __future__ import annotations

import numpy as np

__all__ = ["home_shard", "assign_workers", "local_fraction"]


def home_shard(recs, num_records: int, num_shards: int,
               partitioning: str = "range") -> np.ndarray:
    """Home shard of each record id under a table's declared partitioning
    (vectorized; matches the RSI commit router's binning rule:
    ``"range"`` homes ``r // (R/S)``, ``"hash"`` homes ``r % S``)."""
    recs = np.asarray(recs, np.int64)
    num_shards = int(num_shards)
    if num_shards <= 1:
        return np.zeros(recs.shape, np.int32)
    if partitioning == "range":
        r_local = max(int(num_records) // num_shards, 1)
        return np.minimum(recs // r_local, num_shards - 1).astype(np.int32)
    if partitioning == "hash":
        return (recs % num_shards).astype(np.int32)
    raise ValueError(f"unknown partitioning {partitioning!r}")


def assign_workers(num_workers: int, num_shards: int, *,
                   locality: bool = True) -> np.ndarray:
    """Shard each worker runs on, shape (num_workers,) int32.

    locality=True  — worker ``w`` co-located with shard ``w % S``: its
                     home-affine key range (see
                     ``benchmarks.workloads.worker_write_sets``) is
                     loopback traffic.
    locality=False — the derangement ``(w + 1) % S``: same workload,
                     same verb counts, but every worker's hot range is
                     guaranteed remote (with S == 1 there is nowhere
                     else to sit, so both placements coincide)."""
    num_workers, num_shards = int(num_workers), int(num_shards)
    if num_workers < 1 or num_shards < 1:
        raise ValueError("need at least one worker and one shard")
    w = np.arange(num_workers, dtype=np.int32)
    if locality or num_shards == 1:
        return w % num_shards
    return (w + 1) % num_shards


def local_fraction(recs, worker_shard: int, num_records: int,
                   num_shards: int, partitioning: str = "range") -> float:
    """Fraction of a write/read set that is loopback (home shard ==
    the worker's shard) — the locality the placement actually bought."""
    recs = np.asarray(recs)
    if recs.size == 0:
        return 1.0
    homes = home_shard(recs, num_records, num_shards, partitioning)
    return float(np.mean(homes == int(worker_shard)))
